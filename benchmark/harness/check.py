"""Whether the served tokens are right: the reference's verdict on them.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed and holding the longest, goes
through the plain reference of the configuration's architecture
(``archs/<arch>.py``'s ``reference``, over ``inputs``) with its served
tokens, and each served token's gap is read: how far its logit lies below
the reference's best at that position, in units of the row's standard
deviation over the vocab. The number compared is the widest gap. With
random weights near-ties are common, and a correct program parts from the
reference only where its rounding flips one; an error in the program
parts at gaps that rounding cannot reach.

The control (``verdict``'s ``control``): the reference in the
configuration's control format (the nearest lower precision) put in the
program's place, read the same way: the reference's gap of the token the
control puts first at each position of the same prompts and tokens.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

import archs
from harness import traffic
from reference.numerics import gaps


def sample(records, seed: int, check: dict) -> list:
    """The longest finished request, then others in an order drawn from the
    seed, until ``check["tokens"]`` served tokens and at least
    ``check["min_requests"]`` requests (at most ``check["max_requests"]``)."""
    done = [r for r in records if r.done_t is not None and r.req.error is None and r.req.tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.req.tokens), -r.spec.index))
    out, total = [longest], len(longest.req.tokens)
    for i in np.random.default_rng(int(seed) + 3).permutation(len(done)):
        r = done[i]
        if len(out) >= check["max_requests"]:
            break
        if total >= check["tokens"] and len(out) >= check["min_requests"]:
            break
        if r is not longest:
            out.append(r)
            total += len(r.req.tokens)
    return out


def items(picked, config: dict, pool: np.ndarray, device) -> list:
    """(pixels, prompt ids, served tokens) of each picked request."""
    arch = archs.load(config)
    out = []
    for r in picked:
        pix, ids = arch.inputs(config, traffic.image(pool, r.spec), r.spec.prompt)
        out.append((pix.to(device), ids, np.asarray(r.req.tokens, np.int64)))
    return out


def widest_gap(ref_logits: List[torch.Tensor], tokens: List[np.ndarray]) -> float:
    return max(float(gaps(lg, torch.as_tensor(tok, device=lg.device)).max())
               for lg, tok in zip(ref_logits, tokens))


def verdict(W, config: dict, picked, pool: np.ndarray, device, control: Optional[str] = None) -> dict:
    """{"gap": the served tokens' widest gap, "tokens", "requests"}; with
    ``control`` (a weight format) also "control_gap"."""
    arch = archs.load(config)
    its = items(picked, config, pool, device)
    ref_logits = arch.reference(W, config, config["serve"]["weights"]).served_logits(its)
    out = {"gap": widest_gap(ref_logits, [it[2] for it in its]),
           "tokens": int(sum(len(it[2]) for it in its)), "requests": len(its)}
    if control:
        low = arch.reference(W, config, control).served_logits(its)
        out["control_gap"] = widest_gap(ref_logits, [lg.argmax(-1).cpu().numpy() for lg in low])
    return out
