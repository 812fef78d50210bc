"""Utilities of the port."""

from .logging import AverageMeter, MetricsLogger
from .profiling import profile_trace, step_timer

__all__ = ["AverageMeter", "MetricsLogger", "profile_trace", "step_timer"]
