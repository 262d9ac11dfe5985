"""A cell at tiny widths for the CPU tests: the real cell's files with the
model's sizes, the engine and the mix cut down, one set for 4 query heads
a kv head at head_dim 128 and one for 1 at head_dim 96."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for _p in (BENCH.parent, BENCH):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from harness import cells  # noqa: E402

TEXT = {
    "gqa4": {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 4, "num_attention_heads": 4,
             "num_key_value_heads": 1, "head_dim": 128, "vocab_size": 1500},
    "mha96": {"hidden_size": 48, "intermediate_size": 80, "num_hidden_layers": 4, "num_attention_heads": 2,
              "num_key_value_heads": 2, "head_dim": 96, "vocab_size": 1536},
}
VISION = {"hidden_size": 32, "intermediate_size": 48, "num_hidden_layers": 2, "num_attention_heads": 4,
          "patch_size": 8, "image_size": 32}


def tiny_cell(name: str, layout: str = "gqa4", serve: str = "int8") -> cells.Cell:
    cell = copy.deepcopy(cells.load_cell(name))
    cell.config["text"].update(TEXT[layout])
    cell.config["vision"].update(VISION)
    cell.config["serve"]["weights"] = serve
    cell.config["control"] = "int4" if serve == "int8" else "fp8"
    e = cell.settings["engine"]
    e.update({"n_slots": 4, "chunk": min(e["chunk"], 4), "text_bucket": 64,
              "max_new_tokens": min(e["max_new_tokens"], 24)})
    cell.settings["drain_s"] = 60
    cell.settings["check"].update({"tokens": 120, "min_requests": 3, "max_requests": 24})
    if serve == "bf16":
        # At these widths (seeds 5, 6, 21, 2**31 + 77): the program 0.0117-0.0185,
        # the fp8 control 0.115-0.404.
        cell.settings["check"]["limit"] = 0.06
    mix = cell.traffic
    mix["image_px"] = [20, 60]
    out = mix["output"]
    out["max"] = min(out["max"], 24)
    out["min"] = min(out["min"], out["max"])
    if out["dist"] == "lognormal":
        out["median"] = 6
    if mix["loop"] == "closed":
        mix["clients"] = 6
    else:
        cell.settings["rate_per_s"] = 6.0
    return cell
