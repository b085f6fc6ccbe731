from .sampler import AbstractSampler, AliasTable, RepeatableSampler, Sampler

__all__ = ["AbstractSampler", "AliasTable", "RepeatableSampler", "Sampler"]
