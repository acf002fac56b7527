"""Data substrate: deterministic restartable token pipeline (the port of
``src/repro/data``)."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
