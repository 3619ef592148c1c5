"""Architecture registry: ``--arch <id>`` resolution; the port of
``repro.configs.registry``."""
from __future__ import annotations

import importlib

# arch id -> module path (each exports config() and reduced())
ARCHS = {
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_15_large",
    "whisper-base": "repro_torch.configs.whisper_base",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_16b",
}

# The paper's own GNN workloads (GNNBuilder Table II models).
GNN_ARCHS = {
    "gnnb-gcn": ("gcn",),
    "gnnb-sage": ("sage",),
    "gnnb-gin": ("gin",),
    "gnnb-pna": ("pna",),
}


def get_config(arch: str, reduced: bool = False):
    if arch in GNN_ARCHS:
        from repro_torch.configs import gnn
        return gnn.config(GNN_ARCHS[arch][0], reduced=reduced)
    mod = importlib.import_module(ARCHS[arch])
    return mod.reduced() if reduced else mod.config()


def list_archs() -> list:
    return list(ARCHS) + list(GNN_ARCHS)
