"""Model data plane of the port: configs (base), layers, LoRA, dense LM.

Import ``repro_torch.models.api`` for the serving entry points.
"""
