"""The prefetch-decision walk on the device: one batched step of every
live context, as torch operations, with a numpy reference."""
