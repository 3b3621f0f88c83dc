"""A cell cut to a size the CPU runs in seconds: its configuration's and
traffic's files with the widths, depth, envs, steps and minibatches made
small. Only the tests use it; every cell of the benchmark runs at its
configuration's own size."""

import copy

from benchmark.harness import spec

TINY = {"ViTlucidrains_dim": 32, "ViTlucidrains_depth": 1, "ViTlucidrains_heads": 2,
        "ViTlucidrains_dim_head": 16, "ViTlucidrains_mlp_dim": 64,
        "ViTHG_hidden_size": 32, "ViTHG_num_hidden_layers": 1,
        "ViTHG_num_attention_heads": 2, "ViTHG_intermediate_size": 64,
        "NumStep": 8, "MiniBatch": 4, "Epoch": 1}


def tiny(name: str, envs: int = 4, steps: int = 8):
    cell = copy.deepcopy(spec.cell(name))
    cell["config_spec"]["conf"].update({k: str(v) for k, v in TINY.items()})
    cell["config_spec"]["conf"]["NumStep"] = str(steps)
    cell["traffic_spec"]["overrides"]["num_env_per_process"] = envs
    return cell
