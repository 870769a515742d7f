"""Training substrate of the port (``src/repro/train``): the trainer, its
straggler monitor and elastic mesh manager, and the training collectives
(``compression.compressed_psum``, ``pipeline.gpipe_apply``)."""
from . import checkpoint, compression, fault, pipeline
from .fault import ElasticManager, StragglerMonitor
from .trainer import Trainer, TrainerConfig

__all__ = ["checkpoint", "compression", "fault", "pipeline", "Trainer",
           "TrainerConfig", "StragglerMonitor", "ElasticManager"]
