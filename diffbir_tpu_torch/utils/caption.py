"""Captioners feeding prompts into the text condition.

Counterpart of ``diffbir_tpu/utils/caption.py``: ``build_captioner("none")``
gives the empty caption. "llava" needs the Llama SentencePiece tokenizer to
turn the port's caption ids (``captioners.llava``) into text, and the
repository does not hold that file: it raises FileNotFoundError naming it.
"ram" is RAM++'s tags (``captioners.ram.RAMCaptioner``) on the loop's device;
its checkpoint and tag lists are files, and a missing one raises
FileNotFoundError naming it.
"""

from __future__ import annotations


class Captioner:
    def __call__(self, image) -> str:  # image: HWC uint8 array
        raise NotImplementedError


class EmptyCaptioner(Captioner):
    def __call__(self, image) -> str:
        return ""


def build_captioner(name: str, llava_bit: str = "4", device="cuda") -> Captioner:
    if name == "none":
        return EmptyCaptioner()
    if name == "llava":
        raise FileNotFoundError(
            "--captioner llava needs the Llama SentencePiece tokenizer file tokenizer.model "
            "(llava-hf/llava-1.5-7b-hf) to turn caption ids into text; the repository does "
            "not hold it")
    if name == "ram":
        from ..captioners.ram import RAMCaptioner

        return RAMCaptioner(device=device)
    raise ValueError(f"unsupported captioner: {name}")
