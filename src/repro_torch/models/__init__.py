"""The LM substrate: layers, attention with the ring KV cache, the decoder
stack of the dense family and the ``Model`` API (ports of
``repro/models/{layers,attention,transformer,api}.py``)."""
from repro_torch.models.api import Model, build_model

__all__ = ["Model", "build_model"]
