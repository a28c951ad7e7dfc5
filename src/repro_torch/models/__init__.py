"""The LM substrate: layers, attention with the ring KV cache, the SSD
scan, the hymba block, the MoE layer, the RWKV6 block, the decoder and
encoder stacks and the ``Model`` API (ports of ``repro/models/{layers,
attention,ssm,hymba,moe,rwkv6,transformer,api}.py``)."""
from repro_torch.models.api import EncDecModel, Model, build_model, input_specs

__all__ = ["EncDecModel", "Model", "build_model", "input_specs"]
