from .bfr_loop import BFRInferenceLoop
from .bid_loop import BIDInferenceLoop
from .bsr_loop import BSRInferenceLoop
from .custom_loop import CustomInferenceLoop
from .loop import InferenceLoop
from .unaligned_bfr_loop import UnAlignedBFRInferenceLoop

__all__ = ["InferenceLoop", "BSRInferenceLoop", "BFRInferenceLoop", "BIDInferenceLoop",
           "CustomInferenceLoop", "UnAlignedBFRInferenceLoop"]
