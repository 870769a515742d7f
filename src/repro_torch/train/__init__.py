"""Training substrate of the port (``src/repro/train``): the trainer and
its straggler monitor."""
from .fault import StragglerMonitor
from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "StragglerMonitor"]
