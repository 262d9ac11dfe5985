"""CPU tests of the benchmark's harness: cells, mixes and metrics found by
name from data; the traffic generator; the operation and byte counts
against hand counts; the trace's readings on synthetic events; the
imports of a whole run.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import json
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

import tiny  # noqa: F401  (puts the harness on the path)
from harness import cells, metrics, traffic, work
from harness.trace import SPAN, Event, Trace, is_launch, read

BENCH = cells.benchmark_json()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = cells.load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["loop"] in ("open", "closed")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(metrics.reader(m["name"]))


def test_every_metric_and_config_has_its_file():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (cells.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        cfg = json.loads((cells.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    groups = cells.kernel_groups()
    assert {"q8_gemv", "q8_gemm", "decode_attention", "flash_attention", "token_fetch"} <= set(groups)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load_cell("no-such-cell")


@pytest.mark.parametrize("mix_name", ["docqa-open", "extract-backlog", "transcribe-backlog"])
def test_traffic_repeats_from_its_seed(mix_name):
    mix = json.loads((cells.BENCH_DIR / "traffic" / f"{mix_name}.json").read_text())
    seed = 2**31 + 12345
    a, b = traffic.make_specs(mix, seed, 500, 32), traffic.make_specs(mix, seed, 500, 32)
    assert a == b
    c = traffic.make_specs(mix, seed + 1, 500, 32)
    assert a != c
    for key in ("max_new", "width", "height"):  # the same sizes, in another order
        assert Counter(getattr(s, key) for s in a) == Counter(getattr(s, key) for s in c)
    out = mix["output"]
    p_lo, p_hi = mix["prompt_bytes"]
    i_lo, i_hi = mix["image_px"]
    for s in a:
        assert out["min"] <= s.max_new <= out["max"] or (mix.get("first_wave") and s.index < 32)
        assert 1 <= s.max_new <= out["max"]
        assert p_lo <= len(s.prompt) <= p_hi and s.prompt.isprintable()
        assert i_lo <= s.width <= i_hi and i_lo <= s.height <= i_hi
        assert traffic.image(traffic.noise_pool(seed), s).size == (s.width, s.height)


@pytest.mark.parametrize("mix_name", ["extract-backlog", "transcribe-backlog"])
def test_closed_loop_blocks_hold_the_whole_set(mix_name):
    mix = json.loads((cells.BENCH_DIR / "traffic" / f"{mix_name}.json").read_text())
    k = 32 if mix.get("first_wave") else 0
    n = mix["clients"]
    blocks = []
    for seed in (5, 6):
        specs = traffic.closed_loop(mix, seed, 32)[k:k + 4 * n]
        blocks += [Counter(s.max_new for s in specs[i:i + n]) for i in range(0, 4 * n, n)]
    assert all(b == blocks[0] for b in blocks)


def test_lognormal_lengths_match_the_mix():
    mix = json.loads((cells.BENCH_DIR / "traffic" / "docqa-open.json").read_text())
    lengths = np.array([s.max_new for s in traffic.make_specs(mix, 7, 2000)])
    assert np.median(lengths) == mix["output"]["median"]
    assert lengths.min() == mix["output"]["min"] and lengths.max() <= mix["output"]["max"]


def test_residual_first_wave():
    mix = json.loads((cells.BENCH_DIR / "traffic" / "transcribe-backlog.json").read_text())
    specs = traffic.make_specs(mix, 3, 64, n_slots=32)
    first, rest = [s.max_new for s in specs[:32]], [s.max_new for s in specs[32:]]
    assert min(first) < mix["output"]["min"] and max(first) <= mix["output"]["max"]
    assert all(mix["output"]["min"] <= x <= mix["output"]["max"] for x in rest)
    # The remaining life of a uniform 512-1248 budget met at random: mean
    # E[L^2] / (2 E[L]) ~ 431 for lengths drawn in proportion to themselves.
    assert 330 < np.mean(first) < 530


def test_open_loop_rate_and_window():
    mix = json.loads((cells.BENCH_DIR / "traffic" / "docqa-open.json").read_text())
    rate, seconds = 14.5, 30.0
    specs = traffic.open_loop(mix, 99, rate, seconds)
    t = np.array([s.arrival for s in specs])
    assert len(specs) == round(rate * seconds)
    assert t[0] == 0.0 and np.all(np.diff(t) > 0) and t[-1] < seconds
    gaps = np.diff(t)
    assert abs(gaps.mean() - 1 / rate) < 0.02 / rate
    assert 0.8 < gaps.std() / gaps.mean() < 1.1  # exponential: coefficient of variation 1
    assert [s.arrival for s in traffic.open_loop(mix, 99, rate, seconds)] == list(t)


# -- counts against hand counts ------------------------------------------------

T = {"hidden_size": 8, "intermediate_size": 12, "num_hidden_layers": 2, "num_attention_heads": 4,
     "num_key_value_heads": 2, "head_dim": 3, "vocab_size": 50}
V = {"hidden_size": 6, "intermediate_size": 10, "num_hidden_layers": 3, "num_attention_heads": 2,
     "patch_size": 2, "image_size": 5}


def test_projection_counts_by_hand():
    # qkv (4 + 2 * 2) * 3 = 24 x 8; o 8 x 12; gate_up 24 x 8; down 8 x 12.
    assert work.projections(T) == [(24, 8), (8, 12), (24, 8), (8, 12)]
    assert work.linear_params(T) == 2 * (192 + 96 + 192 + 96)


def test_tower_flops_by_hand():
    n = 4  # (5 // 2) ** 2 patches: the last pixel row and column are dropped
    per_layer = 2 * n * (4 * 36 + 2 * 6 * 10) + 4 * n * n * 6
    assert work.tower_flops(V, 8) == 2 * n * 12 * 6 + 3 * per_layer + 2 * n * 6 * 8


def test_request_flops_by_hand():
    p = 10
    lin = 2 * 1152
    attn = 4 * 2 * 4 * 3  # a query against one key
    prefill = p * lin + attn * p * p + 2 * 8 * 50
    decode = [lin + attn * (p + j) + 2 * 8 * 50 for j in (1, 2, 3)]
    assert work.request_flops(V, T, p, 0, 4) == work.tower_flops(V, 8) + prefill + sum(decode)
    assert work.request_flops(V, T, p, 2, 4) == sum(decode[1:])
    assert work.request_flops(V, T, p, 3, 3) == 0


def test_byte_counts_by_hand():
    rows = 5
    one = lambda o, i, ob=2: o * i + 4 * o + rows * i * 2 + rows * o * ob  # noqa: E731
    layer = one(24, 8) + one(8, 12) + one(24, 8) + one(8, 12)
    assert work.gemv_step_bytes(T, rows) == 2 * layer + one(50, 8, 4)
    flops, nbytes = work.gemm_join(T, 7)
    assert flops == 2 * 7 * 1152
    # Decode attention: K and V of 30 keys over 2 kv heads of 3, q and out of 4 queries over 4 heads.
    assert work.decode_attention_bytes(T, 30, 4) == 2 * (2 * 30 * 2 * 3 * 2 + 2 * 4 * 4 * 3 * 2)
    peaks = {"bf16_flops_per_s": 1e3, "hbm_bytes_per_s": 1e2}
    assert work.bound_s(5e3, 100, peaks) == 5.0 and work.bound_s(1e3, 300, peaks) == 3.0


# -- the trace's readings on synthetic events -----------------------------------

def _ev(name, group, start, end):
    return Event(name, start, end, group)


def test_trace_busy_gaps_and_joins():
    dev = [
        _ev("dec", "decode_attention", 0, 10), _ev("gemv", "q8_gemv", 5, 20),
        _ev("Memcpy DtoH", "token_fetch", 30, 32),
        _ev("pix", None, 40, 45), _ev("flash", "flash_attention", 45, 60), _ev("gemm", "q8_gemm", 60, 95),
        _ev("dec", "decode_attention", 100, 110),
        _ev("Memcpy DtoH", "token_fetch", 120, 121), _ev("ew", None, 121, 125),
        _ev("dec", "decode_attention", 130, 140),
    ]
    host = [Event("engine.step", 0, 200), Event("cudaEventSynchronize", 20, 29)]
    tr = Trace(dev, host, 0, 150, 150e-9)
    assert tr.busy_intervals() == [(0, 20), (30, 32), (40, 95), (100, 110), (120, 125), (130, 140)]
    assert tr.busy_s() == pytest.approx(102e-9)
    joins = tr.join_segments()
    assert len(joins) == 1 and [e.name for e in joins[0]] == ["pix", "flash", "gemm"]
    bd = tr.breakdown(top=2)
    assert bd["device_ops"][0][0] == "gemm"
    # 20-30, 110-120 and 140-150 tie at 10; the first is labelled by the innermost host event.
    assert bd["idle_gaps"] == [["cudaEventSynchronize", pytest.approx(10e-9)], ["engine.step", pytest.approx(10e-9)]]
    assert tr.host_label(25) == "cudaEventSynchronize"
    assert tr.count("decode_attention") == 3 and tr.group_s("q8_gemm") == pytest.approx(35e-9)


def test_roofline_is_the_bound_over_the_group_time():
    dev = [_ev("gemv", "q8_gemv", 0, 60), _ev("gemv", "q8_gemv", 70, 110)]
    tr = Trace(dev, [], 0, 110, 110e-9)
    run = metrics.Run(cells.load_cell(CELLS[0]), {}, [], [], tr, 0.0, cells.peaks())
    assert run.roofline(50e-9, "q8_gemv") == pytest.approx(50.0)
    assert run.roofline(50e-9, "q8_gemm") is None  # no such kernel in the trace
    assert run.roofline(0.0, "q8_gemv") is None  # no work counted


class _KEvent:
    def __init__(self, name, device, corr, start=0, dur=1, annotation=False):
        self._v = (name, device, corr, start, dur, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _: events, "trace_start_ns": lambda _: 0})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_lost_device_records_are_counted_from_the_profiler():
    """Each launch, copy or fill the host issued in the traced span shares
    its correlation id with the device records of its work (a graph launch
    with all its nodes'); a graph launch with none was lost, and so was the
    rest of one that holds a strict part of another's records. An eager
    launch with none is counted apart."""
    graph = [_KEvent("cudaGraphLaunch", False, 11, 10), _KEvent("gemv_kernel<Int8Rows>", True, 11, 15, 3),
             _KEvent("decode_kernel<false>", True, 11, 19, 2), _KEvent("Memcpy DtoH", True, 11, 22, 1)]
    events = [
        _KEvent("cudaLaunchKernel", False, 9, 2), _KEvent(SPAN, False, 0, 5, 95),  # a launch before the span
        *graph,
        _KEvent("cudaLaunchKernel", False, 12, 30), _KEvent("elementwise_kernel", True, 12, 32, 1),
        _KEvent("cudaMemcpyAsync", False, 13, 40), _KEvent("Memcpy DtoH (Device -> Pinned)", True, 13, 41, 1),
        _KEvent("cudaLaunchHostFunc", False, 14, 50),  # no device work of its own
        _KEvent("cudaStreamSynchronize", False, 15, 60), _KEvent("aten::mm", False, 0, 70),
        _KEvent("engine.step", True, 0, 10, 20, annotation=True),
    ]
    tr = read(_Prof(events), 1.0)
    assert (tr.t_start, tr.t_end, tr.window_s) == (5, 100, pytest.approx(95e-9))
    assert (tr.launches, tr.lost, tr.unrecorded) == (3, 0, 0)
    assert [e.name for e in tr.device] == ["gemv_kernel<Int8Rows>", "decode_kernel<false>", "Memcpy DtoH",
                                           "elementwise_kernel", "Memcpy DtoH (Device -> Pinned)"]
    # A second launch of the graph whose last record was lost, a third with none, an eager launch with none.
    again = [_KEvent("cudaGraphLaunch", False, 21, 80), _KEvent("gemv_kernel<Int8Rows>", True, 21, 81, 3),
             _KEvent("decode_kernel<false>", True, 21, 85, 2), _KEvent("cudaGraphLaunch", False, 23, 88),
             _KEvent("cudaLaunchKernel", False, 22, 90)]
    tr = read(_Prof(events + again), 1.0)
    assert (tr.launches, tr.lost, tr.unrecorded) == (6, 2, 1)
    assert is_launch("cudaLaunchKernelExC") and is_launch("cuMemsetD32Async") and not is_launch("cudaEventRecord")


# -- what a whole run imports ----------------------------------------------------

def test_a_run_imports_neither_jax_nor_the_jax_package():
    """A tiny run on the CPU in a fresh interpreter (the harness, the port,
    the reference, every metric reader): no top-level module named jax,
    jaxlib, flax or paligemma_tpu, names compared whole."""
    code = f"""
import sys, time, json
sys.path.insert(0, {str(cells.BENCH_DIR / 'tests')!r})
import tiny, torch, run
from harness import metrics, cells
for m in cells.benchmark_json()["end_to_end"] + cells.benchmark_json()["per_layer"]:
    metrics.reader(m["name"])
cell = tiny.tiny_cell("mistral7b-int8.extract-backlog")
out = run.run_cell(cell, 5, 1.0, 1, torch.device("cpu"), time.perf_counter())
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "paligemma_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "paligemma_tpu"}
