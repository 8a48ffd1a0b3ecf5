from .opt import step_schedule

__all__ = ["step_schedule"]
