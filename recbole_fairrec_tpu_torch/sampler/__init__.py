from .sampler import AbstractSampler, AliasTable, KGSampler, RepeatableSampler, Sampler, SeqSampler

__all__ = [
    "AbstractSampler",
    "AliasTable",
    "KGSampler",
    "RepeatableSampler",
    "Sampler",
    "SeqSampler",
]
