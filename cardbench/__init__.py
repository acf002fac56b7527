"""The on-card benchmark of ``repro_torch`` (see ``README.md``)."""
