"""AdamW and learning-rate schedules (counterpart of ``repro/optim``)."""
