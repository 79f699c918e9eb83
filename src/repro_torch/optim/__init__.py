"""Optimizers, schedules and the Eq 8 NAF loss (port of ``repro.optim``)."""
from . import adamw, naf_loss, schedules
from .adamw import AdamWConfig
