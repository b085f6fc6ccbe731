from .configurator import Config

__all__ = ["Config"]
