"""The port's HTTP server (``server_torch.py --demo --only_cpu``) on the CPU:
health, batched, streaming and bad requests; continuous mode with
concurrent mixed lengths and streams, join errors as 500 or an SSE error,
``/metrics``; ``Admission``; backpressure and deadlines; the ``--kv_window
auto`` rule; ``--adapter`` (a missing directory refused, a saved adapter
served by name); and ``build_server`` serving an
in-memory model whose answers equal the engine's."""
import argparse
import base64
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import server_torch as srv  # noqa: E402


def _b64img(seed=0):
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(seed).randint(0, 255, (32, 40, 3), np.uint8)).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(*flags):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "server_torch.py", "--demo", "--only_cpu", "--port", str(port), *flags],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 240
    while time.time() < deadline:
        try:
            urllib.request.urlopen(base + "/healthz", timeout=5)
            return proc, base
        except (urllib.error.URLError, socket.timeout, ConnectionError):
            if proc.poll() is not None:
                raise RuntimeError(proc.stderr.read().decode()[-2000:])
            time.sleep(1)
    proc.kill()
    raise TimeoutError("server did not come up")


@pytest.fixture(scope="module")
def server():
    proc, base = _start("--batch_window_ms", "300")
    yield base
    proc.kill()
    proc.wait(timeout=30)


@pytest.fixture(scope="module")
def continuous_server():
    proc, base = _start("--continuous", "--n_slots", "2", "--max_new_cap", "32")
    yield base
    proc.kill()
    proc.wait(timeout=30)


def _post(base, path, body, timeout=180):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _stream(base, body, timeout=180):
    req = urllib.request.Request(base + "/generate_stream", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[6:]))
    return events


def test_healthz_and_index(server):
    health = json.loads(urllib.request.urlopen(server + "/healthz").read())
    assert health["status"] == "ok" and health["device"] == "cpu"
    page = urllib.request.urlopen(server + "/").read().decode()
    assert "PaliGemma Analyzer" in page and "/generate_stream" in page


def test_generate_batched(server):
    results = [None, None]

    def worker(i):
        r = _post(server, "/generate", {"prompt": f"q{i}", "image_b64": _b64img(i), "max_tokens": 4})
        results[i] = json.loads(r.read())

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    [t.start() for t in threads]
    [t.join(timeout=180) for t in threads]
    for i, r in enumerate(results):
        assert r["text"].startswith(f"q{i}")
        assert r["batched_with"] >= 1


def test_generate_stream(server):
    events = _stream(server, {"prompt": "s", "image_b64": _b64img(5), "max_tokens": 20})
    assert events[-1] == {"done": True, "num_tokens": 20}
    assert sum(len(e.get("tokens", [])) for e in events[:-1]) == 20


def test_bad_requests(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/generate", {"prompt": "no image"})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/nope", {})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/generate", {"prompt": "x", "image_b64": _b64img(1), "max_tokens": 4, "adapter": "fin"})
    assert e.value.code == 400 and "adapter requires the server to run with --continuous" in e.value.read().decode()


def test_metrics_single_mode(server):
    m = json.loads(urllib.request.urlopen(server + "/metrics").read())
    assert m["mode"] == "batched"
    assert "slots_total" not in m


def test_continuous_concurrent_mixed_lengths(continuous_server):
    """Concurrent requests of different budgets join the running decode; a
    request sent alone gives the tokens it gave among the others."""
    base = continuous_server
    results = {}

    def worker(i, max_tokens):
        with _post(base, "/generate", {"prompt": f"describe item {i}", "image_b64": _b64img(i),
                                       "max_tokens": max_tokens}) as r:
            results[i] = json.loads(r.read())

    threads = [threading.Thread(target=worker, args=(i, mt)) for i, mt in enumerate([6, 14, 10])]
    [t.start() for t in threads]
    [t.join(timeout=180) for t in threads]
    assert set(results) == {0, 1, 2}
    for i, mt in enumerate([6, 14, 10]):
        assert results[i]["continuous"] is True
        assert 1 <= results[i]["num_tokens"] <= mt
    with _post(base, "/generate", {"prompt": "describe item 1", "image_b64": _b64img(1),
                                   "max_tokens": 14}) as r:
        solo = json.loads(r.read())
    assert solo["tokens"] == results[1]["tokens"]


def test_continuous_concurrent_streams(continuous_server):
    base = continuous_server
    results = {}

    def stream(i):
        events = _stream(base, {"prompt": f"stream {i}", "image_b64": _b64img(i + 10), "max_tokens": 10})
        results[i] = [t for e in events if not e.get("done") for t in e["tokens"]]

    threads = [threading.Thread(target=stream, args=(i,)) for i in (0, 1)]
    [t.start() for t in threads]
    [t.join(timeout=180) for t in threads]
    assert set(results) == {0, 1} and all(1 <= len(v) <= 10 for v in results.values())
    together = dict(results)
    stream(0)
    assert results[0] == together[0]


def test_continuous_join_errors_surface(continuous_server):
    """A prompt past the slot prompt budget: 500 on /generate, and an error
    (not a silent empty stream) on /generate_stream."""
    base = continuous_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/generate", {"prompt": "y" * 4000, "image_b64": _b64img(4), "max_tokens": 4}, timeout=120)
    assert e.value.code == 500 and "prompt" in e.value.read().decode()
    with pytest.raises(urllib.error.HTTPError) as e:
        _stream(base, {"prompt": "x" * 4000, "image_b64": _b64img(3), "max_tokens": 4}, timeout=120)
    assert e.value.code == 500 and "prompt" in e.value.read().decode()


def test_metrics_endpoint(continuous_server):
    base = continuous_server
    m0 = json.loads(urllib.request.urlopen(base + "/metrics").read())
    assert m0["mode"] == "continuous" and m0["slots_total"] == 2
    with _post(base, "/generate", {"prompt": "metrics probe", "image_b64": _b64img(42), "max_tokens": 6}) as r:
        out = json.loads(r.read())
    m1 = json.loads(urllib.request.urlopen(base + "/metrics").read())
    assert m1["tokens_delivered"] >= m0.get("tokens_delivered", 0) + out["num_tokens"]
    assert m1["chunks_run"] > m0.get("chunks_run", 0)
    assert m1["requests_completed"] > m0.get("requests_completed", 0)
    assert m1["http_200"] > m0.get("http_200", 0)
    assert m1["chunk_tok_s_ema"] > 0 and m1["in_flight"] == 0
    # The shipped defaults: the adaptive k = 8 ladder and the cache window.
    assert m1["spec_ks"] == [8] and m1["spec_adaptive"] is True and "kv_window" in m1


def test_metrics_count_join_rows(continuous_server):
    base = continuous_server
    with _post(base, "/generate", {"prompt": "rows probe", "image_b64": _b64img(43), "max_tokens": 4}) as r:
        r.read()
    m = json.loads(urllib.request.urlopen(base + "/metrics").read())
    assert m["join_rows"] >= m["join_groups"] >= 1 and 0 <= m["join_pad_rows"] < m["join_rows"]


def test_admission_unit():
    adm = srv.Admission(depth=2)
    with adm.slot():
        with adm.slot():
            with pytest.raises(srv.ServerOverloaded):
                with adm.slot():
                    pass
        with adm.slot():
            pass


def test_backpressure_and_deadline_under_load():
    """Queue depth 1 and a 1 ms deadline: overflow gets 429 + Retry-After,
    admitted requests resolve (504, or 200 if they finish at once); none
    hangs."""
    proc, base = _start("--continuous", "--n_slots", "2", "--max_new_cap", "32", "--queue_depth", "1",
                        "--request_timeout_s", "0.001")
    try:
        codes, retry_after = [], []
        barrier = threading.Barrier(8)

        def worker(i):
            barrier.wait()
            try:
                with _post(base, "/generate", {"prompt": f"load {i}", "image_b64": _b64img(i),
                                               "max_tokens": 32}, timeout=60) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                if e.code == 429:
                    retry_after.append(e.headers.get("Retry-After"))
                e.read()

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        [t.start() for t in threads]
        [t.join(timeout=120) for t in threads]
        assert len(codes) == 8, f"requests hung: only {len(codes)} returned"
        assert set(codes) <= {200, 429, 504}, codes
        assert 429 in codes, codes
        assert all(ra is not None for ra in retry_after)
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_kv_window_auto_resolution():
    def args(**kw):
        d = dict(kv_window="auto", spec_k=4, spec_adaptive="on")
        d.update(kw)
        return argparse.Namespace(**d)

    assert srv._kv_window_enabled(args()) is True
    assert srv._kv_window_enabled(args(spec_k=0)) is False
    assert srv._kv_window_enabled(args(spec_adaptive="off")) is False
    assert srv._kv_window_enabled(args(kv_window="off")) is False
    assert srv._kv_window_enabled(args(kv_window="on", spec_k=0)) is True


def test_adapter_and_lora_rank_are_refused(capsys, tmp_path):
    """An --adapter directory without a saved adapter exits 2 before the
    model loads."""
    assert srv.main(["--demo", "--only_cpu", "--continuous", "--adapter", "fin=/nonexistent"]) == 2
    assert srv.main(["--demo", "--only_cpu", "--continuous", "--lora_rank", "4", "--adapter",
                     f"fin={tmp_path}"]) == 2
    assert "no saved adapter in that directory" in capsys.readouterr().err


def _saved_demo_adapter(path, seed=0):
    """A rank-2 adapter with non-zero B for the demo model, saved by the
    finetune's writer (alpha 4)."""
    import torch

    from inference_torch import load_for_cli
    from paligemma_tpu_torch import lora

    model, _ = load_for_cli(None, True, device="cpu")
    lcfg = lora.LoraConfig(r=2, alpha=4, dropout=0.0)
    ad = lora.init_lora(model.cfg, lcfg, torch.Generator().manual_seed(seed), device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for mod in ad["layers"].values():
        mod["b"] = torch.randn(mod["b"].shape, generator=gen)
    lora.save_checkpoint_robust(ad, lcfg, str(path), step=0)
    return ad, lcfg


def test_continuous_server_serves_an_adapter(tmp_path):
    """``--continuous --adapter fin=DIR``: /healthz lists the adapter, the
    page has the selector, a request naming it answers with the tokens the
    engine gives that adapter in-process, an unknown name is a 400."""
    from inference_torch import load_for_cli
    from paligemma_tpu_torch.continuous import ContinuousBatcher

    ad, lcfg = _saved_demo_adapter(tmp_path / "fin")
    proc, base = _start("--continuous", "--n_slots", "2", "--max_new_cap", "16", "--spec_k", "0",
                        "--kv_window", "off", "--adapter", f"fin={tmp_path / 'fin'}")
    try:
        health = json.loads(urllib.request.urlopen(base + "/healthz").read())
        assert health["adapters"] == ["fin"]
        assert 'id="adapter"' in urllib.request.urlopen(base + "/").read().decode()
        with _post(base, "/generate", {"prompt": "p0", "image_b64": _b64img(0), "max_tokens": 8,
                                       "adapter": "fin"}) as r:
            got = json.loads(r.read())["tokens"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/generate", {"prompt": "p0", "image_b64": _b64img(0), "max_tokens": 8, "adapter": "x"})
        assert e.value.code == 400 and "unknown adapter 'x'; registered: ['fin']" in e.value.read().decode()
    finally:
        proc.kill()
        proc.wait(timeout=30)
    model, processor = load_for_cli(None, True, device="cpu")
    image = Image.open(io.BytesIO(base64.b64decode(_b64img(0)))).convert("RGB")
    refs = []
    for adapter in ("fin", None):
        eng = ContinuousBatcher(model, processor, n_slots=2, max_new_tokens=16, chunk=32, lora_rank=2,
                                prompt_budget=[model.cfg.vision_config.num_image_tokens + 64])
        eng.register_adapter("fin", ad, lcfg.scale)
        req = eng.submit("p0", image, 8, adapter=adapter)
        eng.run()
        eng.close()
        refs.append(req.tokens)
    assert got == refs[0] and refs[0] != refs[1]


def test_build_server_serves_the_engines_tokens():
    """``build_server`` on an in-memory model (as the card's smoke run
    serves the 3B model): the /generate tokens of concurrent requests and a
    stream equal the tokens the same engine settings give in-process."""
    from inference_torch import load_for_cli
    from paligemma_tpu_torch.continuous import ContinuousBatcher

    model, proc = load_for_cli(None, True, device="cpu")
    args = srv.parser().parse_args(["--continuous", "--n_slots", "2", "--max_new_cap", "16", "--chunk", "4",
                                    "--port", str(_free_port())])
    server, _, runner = srv.build_server(model, proc, args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        images = [Image.open(io.BytesIO(base64.b64decode(_b64img(i)))).convert("RGB") for i in range(3)]
        got = {}

        def worker(i):
            with _post(base, "/generate", {"prompt": f"p{i}", "image_b64": _b64img(i), "max_tokens": 9}) as r:
                got[i] = json.loads(r.read())["tokens"]

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        [t.start() for t in threads]
        [t.join(timeout=120) for t in threads]
        events = _stream(base, {"prompt": "p2", "image_b64": _b64img(2), "max_tokens": 9})
        got[2] = [t for e in events if not e.get("done") for t in e["tokens"]]
        eng = ContinuousBatcher(model, proc, n_slots=2, max_new_tokens=16, chunk=4,
                                prompt_budget=[model.cfg.vision_config.num_image_tokens + 64])
        reqs = [eng.submit(f"p{i}", images[i], 9) for i in range(3)]
        eng.run()
        eng.close()
        assert [got[i] for i in range(3)] == [r.tokens for r in reqs]
    finally:
        server.shutdown()
        server.server_close()
