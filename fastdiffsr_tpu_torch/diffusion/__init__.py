from .engine import (DiffusionEngine, DiffusionSpec, counter_noise,
                     counter_normal)
from .schedules import ScheduleBuffers, make_beta_schedule

__all__ = ["make_beta_schedule", "ScheduleBuffers", "DiffusionSpec",
           "DiffusionEngine", "counter_normal", "counter_noise"]
