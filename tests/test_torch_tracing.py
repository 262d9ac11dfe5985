"""The serving engine's own stamps of each request's way to its first
token (``continuous.Request``: ``t_submit``, ``t_taken``, ``t_joined``,
``t_first``), on the CPU.

- They are always on, in lifecycle order, for a lone request and for a
  queued group, and the engine's ``host_t`` keeps its keys.
- A group's members share their join's and their first token's stamps.
- The first token's stamp precedes the streaming hook that hands it on.
- A request cancelled while queued is never taken, joined or served.
"""
import time

import numpy as np
import pytest
from PIL import Image

import paligemma_tpu_torch
from paligemma_tpu_torch.continuous import ContinuousBatcher
from paligemma_tpu_torch.models.paligemma import init_params
from paligemma_tpu_torch.processing import ByteTokenizer, PaliGemmaProcessor, align_config

HOST_T_KEYS = {"preprocess", "h2d", "h2d_staged", "prefill_dispatch", "insert_dispatch", "join_total",
               "decode_dispatch", "fetch", "distribute", "step_total"}
STAMPS = ("t_submit", "t_taken", "t_joined", "t_first")


@pytest.fixture(scope="module")
def setup():
    c0 = paligemma_tpu_torch.tiny_config()
    proc = PaliGemmaProcessor(ByteTokenizer(), c0.vision_config.num_image_tokens, c0.vision_config.image_size)
    model = init_params(align_config(c0, proc), 0, device="cpu")
    rng = np.random.RandomState(7)
    images = [Image.fromarray(rng.randint(0, 255, (20, 28, 3), np.uint8)) for _ in range(5)]
    return model, proc, images


def _engine(setup, **kw):
    model, proc, _ = setup
    return ContinuousBatcher(model, proc, n_slots=2, max_new_tokens=6, chunk=2, **kw)


def _serve(setup, n_requests, **kw):
    images = setup[2]
    eng = _engine(setup, **kw)
    try:
        before = time.perf_counter_ns()
        reqs = [eng.submit(f"q{i}", images[i], max_new_tokens=3 + i % 2) for i in range(n_requests)]
        eng.run()
        after = time.perf_counter_ns()
    finally:
        eng.close()
    assert all(r.done and r.error is None for r in reqs)
    return eng, reqs, before, after


@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "inline"])
@pytest.mark.parametrize("n_requests", [1, 5], ids=["lone", "queued_group"])
def test_request_stamps_in_lifecycle_order(setup, n_requests, prefetch):
    eng, reqs, before, after = _serve(setup, n_requests, prefetch=prefetch)
    for r in reqs:
        assert before <= r.t_submit <= r.t_taken <= r.t_joined <= r.t_first <= after
    assert {"join_total", "decode_dispatch", "fetch", "distribute", "step_total"} <= set(eng.host_t) <= HOST_T_KEYS
    assert eng.host_t["step_total"] >= eng.host_t["join_total"] > eng.host_t["prefill_dispatch"] > 0.0


def test_group_members_share_their_join_and_first_token_stamps(setup):
    eng = _engine(setup)
    images = setup[2]
    try:
        reqs = [eng.submit(f"g{i}", images[i], max_new_tokens=4) for i in range(2)]
        eng.step()  # both slots free: one group joins, and the chunk after it reads its first tokens
        assert reqs[0].t_joined == reqs[1].t_joined is not None
        assert max(r.t_taken for r in reqs) <= reqs[0].t_joined
        assert reqs[0].t_first == reqs[1].t_first is not None
        eng.run()
    finally:
        eng.close()
    assert reqs[0].t_first > reqs[0].t_joined


def test_first_token_stamp_precedes_its_delivery(setup):
    eng = _engine(setup)
    seen = []
    try:
        req = eng.submit("hook", setup[2][0], max_new_tokens=3)
        req.on_tokens = lambda toks, done: seen.append((time.perf_counter_ns(), len(req.tokens)))
        eng.run()
    finally:
        eng.close()
    first_seen = next(t for t, n in seen if n >= 1)
    assert req.t_joined <= req.t_first <= first_seen


def test_request_cancelled_while_queued_is_never_taken(setup):
    eng = _engine(setup)
    try:
        reqs = [eng.submit(f"c{i}", setup[2][i], max_new_tokens=3) for i in range(3)]
        reqs[2].cancelled = True  # queued behind two requests that fill both slots
        eng.run()
    finally:
        eng.close()
    assert reqs[2].done and reqs[2].tokens == []
    assert reqs[2].t_submit is not None and (reqs[2].t_taken, reqs[2].t_joined, reqs[2].t_first) == (None,) * 3
    assert all(None not in (getattr(r, s) for s in STAMPS) for r in reqs[:2])


def test_an_overlapped_join_holds_its_first_token_for_a_chunk(setup):
    """A request that joins behind a running chunk gets its first token
    with the next chunk's read: ``t_first`` comes a step after ``t_joined``."""
    eng = _engine(setup)
    try:
        a = eng.submit("a", setup[2][0], max_new_tokens=6)
        eng.step()
        b = eng.submit("b", setup[2][1], max_new_tokens=3)
        eng.step()  # a's chunk, then b's join enqueued behind it
        assert b.t_joined is not None and b.t_first is None
        eng.step()
        assert b.t_joined < b.t_first
        eng.run()
    finally:
        eng.close()
    assert a.done and b.done and a.t_first < b.t_submit
