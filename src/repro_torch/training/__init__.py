"""Training substrate: optimizer, step functions, compression,
checkpointing.  The port of ``src/repro/training`` (its GPipe schedule,
``pipeline.py``, waits for the sharding slice: ROADMAP Queue 1 item 6)."""
from .optimizer import OptConfig, adamw_init, adamw_update, lr_at
from .train_step import make_steps

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_at", "make_steps"]
