from .bsr_loop import BSRInferenceLoop
from .loop import InferenceLoop

__all__ = ["InferenceLoop", "BSRInferenceLoop"]
