"""Utilities: the profiler hook and accumulating timers."""

from rad_tpu_torch.utils.profiling import Timer, profile_trace

__all__ = ["profile_trace", "Timer"]
