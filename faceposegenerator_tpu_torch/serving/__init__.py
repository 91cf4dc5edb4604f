"""Serving on the card: fixed-shape request batching, LoRA hot-swap and
rolling slots (port of `faceposegenerator_tpu/serving/__init__.py`)."""

from .engine import GenerationRequest, GenerationResult, QueueFull, SamplerServer
from .rolling import RollingServer

__all__ = [
    "GenerationRequest", "GenerationResult", "QueueFull", "SamplerServer",
    "RollingServer",
]
