"""Training substrate: optimizer, step functions (one device or a
mesh), compression, checkpointing with the elastic restore, and the
GPipe schedule (``pipeline.py``).  The port of ``src/repro/training``."""
from .optimizer import OptConfig, adamw_init, adamw_update, lr_at
from .train_step import make_steps

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_at", "make_steps"]
