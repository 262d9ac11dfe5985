"""HTTP inference server of the PyTorch port (``paligemma_tpu_torch``), the
counterpart of ``server.py`` (standard library only).

    python3 server_torch.py --model_path DIR [--continuous] [--port 8000]
    python3 server_torch.py --demo --only_cpu [--batch_window_ms 300 | --continuous ...]
    python3 server_torch.py --model_path DIR --continuous --adapter NAME=DIR [--adapter ...]

Endpoints:
  GET  /healthz           -> {"status": "ok", "model": "...", "device": "..."[,
      "adapters": [...] in continuous mode]}
  GET  /metrics           -> serving counters: HTTP codes, in-flight count and,
      in continuous mode, slot occupancy, engine queue, tokens delivered,
      chunks, prefix-cache and staged-upload hits, speculative acceptance
      and per-mode chunk counts, the cache window
  POST /generate          -> {"text": ..., "tokens": [...], "num_tokens": N}
      JSON body: {"prompt": str, "image_b64": base64 image bytes,
                  "max_tokens": int=100, "temperature": float=0.8,
                  "top_p": float=0.9, "do_sample": bool=false,
                  "adapter": str|null}  (adapter: a LoRA adapter registered
                  at startup with --adapter NAME=DIR; continuous mode only,
                  every decode slot can serve a different adapter)
  POST /generate_stream   -> Server-Sent Events: ``data: {"tokens": [...],
      "text_delta": "..."}`` a decode chunk, then ``data: {"done": true,
      "num_tokens": N}``.

Serving modes: one request at a time (``generation.generate_chunked_stream``
behind a lock), ``--batch_window_ms`` (concurrent /generate requests within
the window coalesce into one ``serving.batch_generate`` batch), and
``--continuous`` (``continuous.ContinuousBatcher``: requests join the
running decode slots between chunks and leave on their EOS; with the
reference's shipped defaults: 32 slots, chunk 32, a 256-token budget, the
adaptive k = 8 speculative ladder and the cache window).

At most ``--queue_depth`` requests are in flight; the next one gets 429 +
Retry-After. A request past ``--request_timeout_s`` is evicted (its slot
frees at the next chunk) and answered 504 (mid-stream: a terminal
``error`` event). Deadlines arm after the warm-up.

The server runs on the CUDA card; ``--only_cpu`` is the only way onto the
CPU, and without it the server exits with an error when there is no card.
``--adapter NAME=DIR`` (repeatable) registers a saved LoRA adapter with the
continuous engine (its rank from the files, its alpha from
``adapter_config.json``; ``--lora_rank`` raises the engine's rank).
``build_server`` makes the server from a loaded model and processor and the
parsed flags; ``main`` loads and calls it.
"""
from __future__ import annotations

import argparse
import base64
import contextlib
import io
import json
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class ServerOverloaded(Exception):
    """Request queue at capacity -> HTTP 429 + Retry-After."""

    def __init__(self, depth: int):
        super().__init__(f"request queue full (depth {depth})")
        self.depth = depth


class RequestTimeout(Exception):
    """Per-request wall-clock deadline exceeded -> HTTP 504."""

    def __init__(self, deadline_s: float):
        super().__init__(f"request exceeded deadline of {deadline_s:.0f}s")
        self.deadline_s = deadline_s


class Admission:
    """At most ``depth`` requests in flight (queued + running) across every
    path; the next one raises ``ServerOverloaded`` at once."""

    def __init__(self, depth: int = 64, deadline_s=None):
        self.depth = depth
        self.deadline_s = deadline_s if deadline_s else None
        self._n = 0
        self._mu = threading.Lock()

    @contextlib.contextmanager
    def slot(self):
        with self._mu:
            if self._n >= self.depth:
                raise ServerOverloaded(self.depth)
            self._n += 1
        try:
            yield
        finally:
            with self._mu:
                self._n -= 1


class Metrics:
    """Counters behind ``GET /metrics``: HTTP codes (counted in the
    handler's ``_send``), and the useful-tokens/s EMA of the continuous
    loop's chunks; engine gauges are read at scrape time."""

    def __init__(self):
        self._mu = threading.Lock()
        self.counters: dict = {}
        self.tok_s_ema = None
        self.started = time.time()

    def inc(self, name: str, n: int = 1) -> None:
        with self._mu:
            self.counters[name] = self.counters.get(name, 0) + n

    def observe_chunk(self, tokens: int, dt_s: float) -> None:
        """One engine-loop iteration delivered ``tokens`` in ``dt_s``."""
        if dt_s <= 0 or tokens <= 0:
            return
        rate = tokens / dt_s
        with self._mu:
            self.tok_s_ema = rate if self.tok_s_ema is None else 0.8 * self.tok_s_ema + 0.2 * rate

    def snapshot(self) -> dict:
        with self._mu:
            out = dict(self.counters)
            out["uptime_s"] = round(time.time() - self.started, 1)
            if self.tok_s_ema is not None:
                out["chunk_tok_s_ema"] = round(self.tok_s_ema, 1)
        return out


class Engine:
    """A loaded model and processor with a serial inference lock."""

    def __init__(self, model, processor, model_name: str):
        from paligemma_tpu_torch.processing import assert_aligned

        assert_aligned(processor, model.cfg)
        self.model, self.processor, self.model_name = model, processor, model_name
        self.device = model.llm.final_norm.weight.device
        self.lock = threading.Lock()

    def _inputs(self, prompt, image):
        import torch

        inputs = self.processor(text=[prompt], images=[image])
        ids = torch.from_numpy(inputs["input_ids"]).to(self.device)
        pix = torch.from_numpy(inputs["pixel_values"]).to(self.device, self.model.vision.patch_embedding.weight.dtype)
        return ids, pix

    def _pieces(self, ids, pix, max_tokens, temperature, top_p, do_sample):
        from paligemma_tpu_torch import generation

        return generation.generate_chunked_stream(
            self.model, ids, pix, max_tokens, self.processor.tokenizer.eos_token_id,
            do_sample=do_sample, temperature=temperature, top_p=top_p)

    def generate(self, prompt, image, max_tokens, temperature, top_p, do_sample, deadline_s=None):
        ids, pix = self._inputs(prompt, image)
        deadline = time.time() + deadline_s if deadline_s else None
        tokens: list = []
        with self.lock:
            # A deadline check between chunks: one long request cannot hold
            # the lock past its budget.
            for piece in self._pieces(ids, pix, max_tokens, temperature, top_p, do_sample):
                tokens.extend(piece)
                if deadline is not None and time.time() > deadline:
                    raise RequestTimeout(deadline_s)
        text = self.processor.tokenizer.decode(tokens, skip_special_tokens=True)
        return {"text": prompt + text, "tokens": tokens, "num_tokens": len(tokens)}

    def generate_stream(self, prompt, image, max_tokens, temperature, top_p, do_sample,
                        deadline_s=None):
        """Yields (new_tokens, text_delta) a decode chunk. A worker thread
        holds the lock only while it computes; chunks flow through a queue,
        so a slow client delays only its own connection."""
        ids, pix = self._inputs(prompt, image)
        chunks: "queue.Queue" = queue.Queue()
        sentinel = object()
        cancel = threading.Event()
        deadline = time.time() + deadline_s if deadline_s else None

        def worker():
            try:
                with self.lock:
                    for piece in self._pieces(ids, pix, max_tokens, temperature, top_p, do_sample):
                        chunks.put(piece)
                        if cancel.is_set():
                            break
                        if deadline is not None and time.time() > deadline:
                            raise RequestTimeout(deadline_s)
                chunks.put(sentinel)
            except Exception as e:  # surfaced to the consumer
                chunks.put(e)

        threading.Thread(target=worker, daemon=True).start()
        seen, prev_text = [], ""
        try:
            while True:
                piece = chunks.get()
                if piece is sentinel:
                    return
                if isinstance(piece, Exception):
                    raise piece
                seen.extend(piece)
                # Byte-level tokenizers give stable text only for the whole sequence.
                text = self.processor.tokenizer.decode(seen, skip_special_tokens=True)
                yield piece, text[len(prev_text):]
                prev_text = text
        finally:
            cancel.set()


class Batcher:
    """Coalesces concurrent /generate requests within a time window into one
    padded ``serving.batch_generate`` batch (requests with the head's
    sampling values and budget; the rest wait for the next window)."""

    PROMPT_BUCKET = 64
    BATCH_BUCKET = 4

    def __init__(self, engine: Engine, window_ms: float, max_batch: int = 8, queue_depth: int = 64,
                 deadline_s=None):
        self.engine = engine
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self.deadline_s = deadline_s if deadline_s else None
        self.queue: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, request: dict) -> dict:
        """Blocks until the batched result for this request is ready."""
        slot = {"request": request, "event": threading.Event(), "result": None,
                "deadline": time.time() + self.deadline_s if self.deadline_s else None}
        try:
            self.queue.put_nowait(slot)
        except queue.Full:
            raise ServerOverloaded(self.queue.maxsize) from None
        slot["event"].wait()
        if isinstance(slot["result"], Exception):
            raise slot["result"]
        return slot["result"]

    @staticmethod
    def _key(r):
        return r["max_tokens"], r["temperature"], r["top_p"], r["do_sample"]

    def _loop(self):
        pending: list = []
        while True:
            if not pending:
                pending.append(self.queue.get())
            deadline = time.time() + self.window
            while len(pending) < self.max_batch:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    pending.append(self.queue.get(timeout=timeout))
                except queue.Empty:
                    break
            now = time.time()
            expired = [s for s in pending if s["deadline"] is not None and now > s["deadline"]]
            for s in expired:
                s["result"] = RequestTimeout(self.deadline_s)
                s["event"].set()
            pending = [s for s in pending if s not in expired]
            if not pending:
                continue
            head = self._key(pending[0]["request"])
            group = [s for s in pending if self._key(s["request"]) == head]
            pending = [s for s in pending if self._key(s["request"]) != head]
            self._run(group)

    def _run(self, group):
        from paligemma_tpu_torch import serving

        try:
            reqs = [s["request"] for s in group]
            r0 = reqs[0]
            with self.engine.lock:
                texts, token_rows = serving.batch_generate(
                    self.engine.model, self.engine.processor, [r["prompt"] for r in reqs],
                    [r["image"] for r in reqs], max_new_tokens=r0["max_tokens"], do_sample=r0["do_sample"],
                    temperature=r0["temperature"], top_p=r0["top_p"], prompt_bucket=self.PROMPT_BUCKET,
                    batch_bucket=min(self.BATCH_BUCKET, self.max_batch), return_tokens=True)
            for slot, req, text, toks in zip(group, reqs, texts, token_rows):
                slot["result"] = {"text": req["prompt"] + text, "tokens": toks, "num_tokens": len(toks),
                                  "batched_with": len(group)}
                slot["event"].set()
        except Exception as e:
            for slot in group:
                slot["result"] = e
                slot["event"].set()


class ContinuousRunner:
    """Continuous batching behind /generate and /generate_stream: one thread
    drives ``ContinuousBatcher.step``; requests join its slots between
    chunks. The same blocking ``submit(request) -> dict`` as ``Batcher``.
    ``adapters``: {name: (adapter, scale)} registered with the engine
    before its graphs are captured; requests pick one by name."""

    def __init__(self, engine: Engine, n_slots: int = 4, chunk: int = 8, max_new_cap: int = 256,
                 prompt_extra=(64,), lora_rank=None, adapters=None, prefill_cache=0,
                 queue_depth: int = 64, deadline_s=None,
                 spec_k: int = 0, spec_adaptive: bool = True, spec_max_slots=None, spec_chunk=None,
                 spec_ks=None, spec_drafter: str = "ngram", kv_quant: bool = False,
                 kv_window: bool = False, metrics: Metrics = None):
        from paligemma_tpu_torch.continuous import ContinuousBatcher

        self.engine = engine
        n_img = engine.model.cfg.vision_config.num_image_tokens
        self.max_new_cap = max_new_cap
        self.metrics = metrics or Metrics()
        if isinstance(prompt_extra, int):
            prompt_extra = (prompt_extra,)
        self.batcher = ContinuousBatcher(
            engine.model, engine.processor, n_slots=n_slots, chunk=chunk,
            prompt_budget=[n_img + e for e in prompt_extra], max_new_tokens=max_new_cap,
            prefill_cache_size=prefill_cache, spec_k=spec_k, spec_ks=spec_ks, spec_adaptive=spec_adaptive,
            spec_max_slots=spec_max_slots,
            # Adaptive default: speculative chunks at half the plain cadence.
            spec_chunk=spec_chunk or (max(1, chunk // 2) if ((spec_k or spec_ks) and spec_adaptive) else None),
            kv_quant=kv_quant, kv_window=kv_window, spec_drafter=spec_drafter, lora_rank=lora_rank,
        )
        for name, (tree, scale) in (adapters or {}).items():
            self.batcher.register_adapter(name, tree, scale)
        self.batcher.prepare()  # every graph captured before traffic (CUDA)
        self.queue: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self.deadline_s = deadline_s if deadline_s else None
        self.waiters = {}  # Request.id -> the handler's slot
        self._emitted = 0  # batcher.completed delivered so far
        threading.Thread(target=self._loop, daemon=True).start()

    def _new_slot(self, request: dict, **extra) -> dict:
        slot = {"request": request, "event": threading.Event(), "result": None,
                "deadline": time.time() + self.deadline_s if self.deadline_s else None, **extra}
        try:
            self.queue.put_nowait(slot)
        except queue.Full:
            raise ServerOverloaded(self.queue.maxsize) from None
        return slot

    def submit(self, request: dict) -> dict:
        slot = self._new_slot(request)
        # Deadline evictions arrive at chunk boundaries; the grace here only
        # guards against a wedged device.
        grace = self.deadline_s * 2 + 120 if self.deadline_s else None
        if not slot["event"].wait(timeout=grace):
            slot["cancelled"] = True
            creq = slot.get("creq")
            if creq is not None:
                creq.cancelled = True
            self.metrics.inc("evictions_wedged")
            raise RequestTimeout(self.deadline_s)
        if isinstance(slot["result"], Exception):
            raise slot["result"]
        return slot["result"]

    def submit_stream(self, prompt, image, max_tokens, temperature, top_p, do_sample, adapter=None):
        """Yields (new_tokens, text_delta) a decode chunk, multiplexed over
        the slots (many streams decode at once)."""
        chunks: "queue.Queue" = queue.Queue()
        slot = self._new_slot({"prompt": prompt, "image": image, "max_tokens": max_tokens,
                               "temperature": temperature, "top_p": top_p, "do_sample": do_sample,
                               "adapter": adapter}, stream_q=chunks)
        tok = self.engine.processor.tokenizer
        seen, prev_text = [], ""
        try:
            while True:
                piece, done = chunks.get()
                if isinstance(piece, Exception):
                    raise piece
                if piece:
                    seen.extend(piece)
                    text = tok.decode(seen, skip_special_tokens=True)
                    yield piece, text[len(prev_text):]
                    prev_text = text
                if done:
                    return
        finally:
            slot["cancelled"] = True
            creq = slot.get("creq")
            if creq is not None:
                creq.cancelled = True

    def _fail(self, slot, err) -> None:
        sq = slot.get("stream_q")
        if sq is not None:
            sq.put((err, True))
        else:
            slot["result"] = err
            slot["event"].set()

    def _admit(self, items) -> None:
        now = time.time()
        for slot in items:
            req = slot["request"]
            if slot["deadline"] is not None and now > slot["deadline"]:
                self.metrics.inc("evictions_queued")
                self._fail(slot, RequestTimeout(self.deadline_s))
                continue
            try:
                creq = self.batcher.submit(req["prompt"], req["image"], min(req["max_tokens"], self.max_new_cap),
                                           temperature=req.get("temperature"), top_p=req.get("top_p"),
                                           do_sample=req.get("do_sample"), adapter=req.get("adapter"))
                sq = slot.get("stream_q")
                if sq is not None:
                    # A join error reaches the stream as an error, not a
                    # silent empty 200.
                    def notify(toks, done, _q=sq, _r=creq):
                        _q.put((_r.error, True) if done and _r.error is not None else (toks, done))

                    creq.on_tokens = notify
                slot["creq"] = creq
                if slot.get("cancelled"):
                    creq.cancelled = True
                self.waiters[creq.id] = slot
            except Exception as e:
                self._fail(slot, e)

    def _loop(self):
        b = self.batcher
        while True:
            idle = not any(r is not None for r in b.slot_req) and not b.pending
            items = [self.queue.get()] if idle else []
            while True:
                try:
                    items.append(self.queue.get_nowait())
                except queue.Empty:
                    break
            self._admit(items)
            if self.deadline_s:
                now = time.time()
                for slot in list(self.waiters.values()):
                    creq = slot.get("creq")
                    if (creq is not None and not creq.done and slot["deadline"] is not None
                            and now > slot["deadline"] and creq.error is None):
                        self.metrics.inc("evictions_deadline")
                        creq.error = RequestTimeout(self.deadline_s)
                        creq.cancelled = True
            active = 0
            t0 = time.time()
            toks0 = b.tokens_delivered
            try:
                with self.engine.lock:
                    active = sum(r is not None for r in b.slot_req)
                    b.step()
                self.metrics.observe_chunk(b.tokens_delivered - toks0, time.time() - t0)
            except Exception as e:
                # An engine fault must not kill this thread (every waiter
                # would hang): fail the requests in flight, free the slots.
                for i, creq in enumerate(b.slot_req):
                    if creq is not None:
                        creq.error = e
                        creq.done = True
                        b.completed.append(creq)
                        if creq.on_tokens is not None:
                            creq.on_tokens([], True)
                        b.slot_req[i] = None
            comp = b.completed
            while self._emitted < len(comp):
                creq = comp[self._emitted]
                self._emitted += 1
                slot = self.waiters.pop(creq.id, None)
                if slot is None or slot.get("stream_q") is not None:
                    continue  # streamed: delivered through on_tokens
                if creq.error is not None:
                    slot["result"] = creq.error
                else:
                    slot["result"] = {"text": slot["request"]["prompt"] + b.decode_text(creq),
                                      "tokens": creq.tokens, "num_tokens": len(creq.tokens),
                                      "continuous": True, "batched_with": active}
                slot["event"].set()


INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>PaliGemma Analyzer (GPU)</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:640px;margin:2rem auto;padding:0 1rem}
 textarea,input,button{font:inherit;width:100%;box-sizing:border-box;margin:.25rem 0}
 #out{white-space:pre-wrap;border:1px solid #ccc;border-radius:6px;padding:.75rem;
      min-height:4rem;background:#fafafa}
 img{max-width:200px;display:block;margin:.5rem 0}
 .row{display:flex;gap:.5rem}.row>*{flex:1}
</style></head><body>
<h2>PaliGemma Analyzer (GPU)</h2>
<input type="file" id="img" accept="image/*">
<img id="preview" hidden>
<textarea id="prompt" rows="2">Describe the image</textarea>
<div class="row">
 <label>max tokens <input id="maxtok" type="number" value="100"></label>
 <label>temperature <input id="temp" type="number" step="0.1" value="0.8"></label>
 <label>top-p <input id="topp" type="number" step="0.05" value="0.9"></label>
 <label>sample <input id="sample" type="checkbox" style="width:auto"></label>
</div>
<label id="adrow" hidden>adapter
 <select id="adapter"><option value="">(base model)</option></select></label>
<button id="go">Analyze</button>
<h3>PaliGemma Insight</h3><div id="out"></div>
<script>
let b64=null;
// Registered LoRA adapters (server --adapter NAME=DIR) populate a selector.
fetch('/healthz').then(r=>r.json()).then(h=>{
 if(h.adapters&&h.adapters.length){
  for(const a of h.adapters){const o=document.createElement('option');
   o.value=a;o.textContent=a;adapter.appendChild(o);}
  adrow.hidden=false;}}).catch(()=>{});
img.onchange=()=>{const f=img.files[0];const r=new FileReader();
 r.onload=()=>{b64=r.result.split(',')[1];preview.src=r.result;preview.hidden=false};
 r.readAsDataURL(f);};
go.onclick=async()=>{
 if(!b64){out.textContent='upload an image first';return}
 out.textContent='';go.disabled=true;
 const body=JSON.stringify({prompt:prompt.value,image_b64:b64,
   max_tokens:+maxtok.value,temperature:+temp.value,top_p:+topp.value,
   do_sample:sample.checked,adapter:adapter.value||null});
 const resp=await fetch('/generate_stream',{method:'POST',body,
   headers:{'Content-Type':'application/json'}});
 if(!resp.ok){out.textContent='error: '+await resp.text();go.disabled=false;return}
 const reader=resp.body.getReader();const dec=new TextDecoder();let buf='';
 for(;;){const {done,value}=await reader.read();if(done)break;
  buf+=dec.decode(value,{stream:true});
  let i;while((i=buf.indexOf('\\n\\n'))>=0){const line=buf.slice(0,i);buf=buf.slice(i+2);
   if(line.startsWith('data: ')){const ev=JSON.parse(line.slice(6));
    if(ev.text_delta)out.textContent+=ev.text_delta;}}}
 go.disabled=false;};
</script></body></html>"""


def make_handler(engine: Engine, batcher=None, admission: Admission = None, metrics: Metrics = None):
    admission = admission or Admission()
    metrics = metrics or Metrics()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload, headers=None):
            metrics.inc(f"http_{code}")
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _metrics_payload(self):
            m = metrics.snapshot()
            m["in_flight"] = admission._n
            m["queue_depth_max"] = admission.depth
            continuous = isinstance(batcher, ContinuousRunner)
            m["mode"] = "continuous" if continuous else "batched" if batcher is not None else "single"
            if continuous:
                b = batcher.batcher
                m.update(slots_total=b.n_slots, slots_occupied=sum(r is not None for r in b.slot_req),
                         engine_queue=len(b.pending) + batcher.queue.qsize(),
                         requests_completed=len(b.completed), tokens_delivered=b.tokens_delivered,
                         chunks_run=b.chunks_run, join_groups=b.join_groups, join_rows=b.join_rows,
                         join_pad_rows=b.join_pad_rows,
                         prefill_cache_hits=b.prefill_cache_hits, staged_upload_hits=b.staged_hits,
                         staged_upload_misses=b.staged_misses, pixel_affine=b.pixel_affine,
                         graphs_captured=len(b.graph_log))
                if b.spec_k:
                    log, klog = b.spec_mode_log, b.spec_k_log
                    m.update(spec_k=b.spec_k, spec_ks=list(b.spec_ks), spec_rung_k=b.spec_ks[b._spec_rung],
                             spec_adaptive=b.spec_adaptive, spec_verifies=b.spec_verifies,
                             spec_emitted=b.spec_emitted, spec_chunks=sum(log),
                             plain_chunks=len(log) - sum(log),
                             spec_k_chunks={str(k): sum(1 for x in klog if x == k) for k in b.spec_ks})
                    if b.spec_accept_ema is not None:
                        m["spec_accept_ema"] = round(b.spec_accept_ema, 3)
                if b.window_buckets:
                    m.update(kv_window=b.window, kv_window_buckets=list(b.window_buckets),
                             kv_window_resizes=b.window_resizes)
            return m

        def do_GET(self):
            if self.path == "/healthz":
                info = {"status": "ok", "model": engine.model_name, "device": str(engine.device)}
                if isinstance(batcher, ContinuousRunner):
                    info["adapters"] = batcher.batcher.adapters
                self._send(200, info)
            elif self.path == "/metrics":
                self._send(200, self._metrics_payload())
            elif self.path in ("/", "/index.html"):
                body = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path not in ("/generate", "/generate_stream"):
                return self._send(404, {"error": f"unknown path {self.path}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                prompt = req["prompt"]
                if not isinstance(prompt, str):
                    raise ValueError("prompt must be a string")
                params = dict(max_tokens=int(req.get("max_tokens", 100)),
                              temperature=float(req.get("temperature", 0.8)),
                              top_p=float(req.get("top_p", 0.9)),
                              do_sample=bool(req.get("do_sample", False)))
                if params["max_tokens"] < 1:
                    raise ValueError("max_tokens must be >= 1")
                adapter = req.get("adapter")
                if adapter is not None:
                    # Adapters ride the continuous slots only; a bad name is a
                    # 400, a join failure stays a 500.
                    if not isinstance(batcher, ContinuousRunner):
                        raise ValueError("adapter requires the server to run with --continuous "
                                         "(and --adapter NAME=DIR)")
                    if adapter not in batcher.batcher.adapters:
                        raise ValueError(f"unknown adapter {adapter!r}; registered: {batcher.batcher.adapters}")
                    params["adapter"] = str(adapter)
                from PIL import Image

                image = Image.open(io.BytesIO(base64.b64decode(req["image_b64"]))).convert("RGB")
            except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                return self._send(400, {"error": f"bad request: {e!r}"})
            except Exception as e:
                return self._send(400, {"error": f"bad image: {e!r}"})

            if self.path == "/generate_stream":
                return self._stream(prompt, image, params)
            try:
                with admission.slot():
                    if batcher is not None:
                        out = batcher.submit({"prompt": prompt, "image": image, **params})
                    else:
                        out = engine.generate(prompt, image, **params, deadline_s=admission.deadline_s)
                self._send(200, out)
            except ServerOverloaded as e:
                self._send(429, {"error": str(e)}, headers={"Retry-After": "1"})
            except RequestTimeout as e:
                self._send(504, {"error": str(e)})
            except Exception as e:  # engine errors as 500s
                self._send(500, {"error": repr(e)})

        def _stream(self, prompt, image, params):
            """Server-Sent Events, one event a decode chunk."""
            try:
                ctx = admission.slot()
                ctx.__enter__()
            except ServerOverloaded as e:
                return self._send(429, {"error": str(e)}, headers={"Retry-After": "1"})
            try:
                try:
                    if isinstance(batcher, ContinuousRunner):
                        gen = batcher.submit_stream(prompt, image, **params)
                    else:
                        gen = engine.generate_stream(prompt, image, **params, deadline_s=admission.deadline_s)
                    first = next(gen)  # the prefill runs before the 200 is committed
                except StopIteration:
                    first, gen = None, iter(())
                except ServerOverloaded as e:
                    return self._send(429, {"error": str(e)}, headers={"Retry-After": "1"})
                except RequestTimeout as e:
                    return self._send(504, {"error": str(e)})
                except Exception as e:
                    return self._send(500, {"error": repr(e)})

                metrics.inc("http_200_stream")
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                total = 0

                def emit(piece, delta):
                    nonlocal total
                    total += len(piece)
                    payload = json.dumps({"tokens": piece, "text_delta": delta})
                    self.wfile.write(f"data: {payload}\n\n".encode())
                    self.wfile.flush()

                try:
                    if first is not None:
                        emit(*first)
                    for piece, delta in gen:
                        emit(piece, delta)
                    self.wfile.write(f"data: {json.dumps({'done': True, 'num_tokens': total})}\n\n".encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the client went away
                except Exception as e:
                    # A failure after the 200 (a deadline eviction): a
                    # terminal error event.
                    try:
                        payload = json.dumps({"error": str(e), "done": True})
                        self.wfile.write(f"data: {payload}\n\n".encode())
                        self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass
            finally:
                ctx.__exit__(None, None, None)

        def log_message(self, fmt, *args):  # stderr, keep stdout clean
            print(f"[server] {fmt % args}", file=sys.stderr)

    return Handler


def _spec_config(args):
    """(spec_k, spec_ks) from --spec_k / --spec_ks: --spec_k is one fixed
    depth (0 off; 1 refused), else the --spec_ks ladder, adaptive, or its
    deepest rung statically with --spec_adaptive off."""
    if args.spec_k is not None:
        if args.spec_k == 1:
            raise SystemExit("--spec_k must be 0 (off) or >= 2 (1+ draft tokens)")
        return args.spec_k, None
    ks = tuple(sorted({int(x) for x in args.spec_ks.split(",") if x.strip()}))
    if not ks:
        return 0, None
    if args.spec_adaptive != "on":
        return ks[-1], None
    return 0, ks


def _kv_window_enabled(args) -> bool:
    """--kv_window {on,off,auto}: auto turns the cache window on exactly
    when adaptive speculation is on (the reference's rule)."""
    if args.kv_window == "on":
        return True
    spec_k, spec_ks = _spec_config(args)
    return args.kv_window == "auto" and bool(spec_k or spec_ks) and args.spec_adaptive == "on"


def _buckets(spec: str):
    vals = tuple(int(x) for x in spec.split(",") if x.strip())
    if not vals or any(v < 1 for v in vals):
        raise argparse.ArgumentTypeError(f"expected comma-separated positive ints, got {spec!r}")
    return vals


def parser() -> argparse.ArgumentParser:
    """The flags of ``server.py``, with the reference's defaults."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--demo", action="store_true", help="tiny random model + byte tokenizer")
    p.add_argument("--only_cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help=">0: coalesce concurrent /generate requests into one padded batch within this window")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--continuous", action="store_true",
                   help="slot-level continuous batching: requests join the running decode between chunks "
                        "and leave on EOS; per-request sampling values ride the slots")
    p.add_argument("--n_slots", type=int, default=32, help="continuous mode: decode batch width")
    p.add_argument("--chunk", type=int, default=32, help="continuous mode: decode steps a chunk")
    p.add_argument("--max_new_cap", type=int, default=256,
                   help="continuous mode: each slot's token budget (the cache is sized for it)")
    p.add_argument("--lora_rank", type=int, default=None,
                   help="continuous mode: serve LoRA adapters up to this rank (default: the largest --adapter's)")
    p.add_argument("--adapter", action="append", default=[], metavar="NAME=DIR",
                   help="register a LoRA adapter directory (saved by the finetune) under NAME; repeatable; "
                        "requests select one with the 'adapter' field (continuous mode)")
    p.add_argument("--quant", choices=["none", "int8", "w4a8"], default="none",
                   help="int8: weight-only int8 decoder; w4a8: int4 MLP weights + int8 activations")
    p.add_argument("--prompt_buckets", type=_buckets, default=(64,),
                   help="continuous mode: comma-separated text-token budgets on top of the image tokens; a "
                        "join group prefills at the smallest bucket covering its prompts")
    p.add_argument("--queue_depth", type=int, default=64,
                   help="max in-flight requests; the next one gets 429 + Retry-After")
    p.add_argument("--request_timeout_s", type=float, default=120.0,
                   help="per-request wall-clock deadline (504 past it); 0 disables")
    p.add_argument("--spec_k", type=int, default=None,
                   help="continuous mode, >= 2: one fixed speculative draft depth; 0 disables speculation. "
                        "Default: the --spec_ks ladder")
    p.add_argument("--spec_ks", type=str, default="8",
                   help="continuous mode with --spec_adaptive: comma-separated ascending draft-depth rungs")
    p.add_argument("--spec_drafter", choices=["ngram", "longest"], default="ngram")
    p.add_argument("--spec_adaptive", choices=["on", "off"], default="on",
                   help="choose per chunk between speculative and plain chunks from occupancy and the "
                        "acceptance EMA; off = always speculate")
    p.add_argument("--spec_max_slots", type=int, default=None,
                   help="adaptive speculation: occupied slots above which chunks run plain (default: none)")
    p.add_argument("--spec_chunk", type=int, default=None,
                   help="verify iterations a speculative chunk (default: chunk/2 when adaptive, else chunk)")
    p.add_argument("--kv_quant", choices=["on", "off"], default="off", help="continuous mode: int8 KV cache")
    p.add_argument("--kv_window", choices=["on", "off", "auto"], default="auto",
                   help="continuous mode: occupancy-bounded cache window; auto: on with adaptive speculation")
    p.add_argument("--prefill_a8", choices=["on", "off"], default="off",
                   help="int8 x int8 prefill projections (requires --quant int8 or w4a8)")
    p.add_argument("--prefill_cache", type=int, default=0,
                   help="continuous mode: LRU size of the content-keyed prefix cache")
    return p


def _warm_continuous(batcher: ContinuousRunner, size: int, prompt_buckets, n_slots: int) -> None:
    """Run every prompt bucket once before traffic (the runner's engine
    captured its graphs in ``prepare()``): a batch-1 join, then n_slots
    concurrent requests, so each eager path of a join has run."""
    from PIL import Image

    for extra in prompt_buckets:
        req = {"prompt": "w" * max(1, extra - 2), "image": Image.new("RGB", (size, size)),
               "max_tokens": 8, "temperature": 0.0, "top_p": 0.9, "do_sample": False}
        batcher.submit(dict(req))
        ts = [threading.Thread(target=batcher.submit, args=(dict(req),)) for _ in range(n_slots)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()


def _adapter_specs(specs):
    """[(name, directory)] from the ``--adapter NAME=DIR`` values."""
    out = []
    for spec in specs:
        name, _, path = spec.partition("=")
        if not name or not path:
            raise SystemExit(f"--adapter expects NAME=DIR, got {spec!r}")
        out.append((name, path))
    return out


def _load_adapters(specs, lora_rank, device):
    """({name: (adapter, alpha / r)}, engine rank) from ``--adapter``: each
    adapter's rank from its files, its alpha from ``adapter_config.json``;
    the engine's rank is the largest of them and ``--lora_rank``."""
    from paligemma_tpu_torch import lora

    adapters = {}
    for name, path in _adapter_specs(specs):
        tree = lora.load_adapter(path, device=device)
        r = int(tree.get("layers", tree)["q"]["a"].shape[-1])
        r_cfg, alpha = lora.saved_rank_alpha(path, r)
        adapters[name] = (tree, alpha / r_cfg)
        lora_rank = max(lora_rank or 0, r)
    return adapters, lora_rank


def build_server(model, processor, args, model_name: str = "model", host: str = "127.0.0.1"):
    """The HTTP server for a loaded (model, processor) and the parsed flags
    (``parser()``): the engine in the flags' mode, warmed up (its graphs
    captured), deadlines armed after the warm-up. Returns (server, engine,
    runner or None); the caller runs ``server.serve_forever()``."""
    from PIL import Image

    engine = Engine(model, processor, model_name)
    metrics = Metrics()
    size = model.cfg.vision_config.image_size
    engine.generate("warmup", Image.new("RGB", (size, size)), 4, 0.0, 0.9, False)
    print("warm-up complete", file=sys.stderr, flush=True)
    if args.continuous:
        spec_k, spec_ks = _spec_config(args)
        adapters, lora_rank = _load_adapters(args.adapter, args.lora_rank, engine.device)
        batcher = ContinuousRunner(
            engine, n_slots=args.n_slots, chunk=args.chunk, max_new_cap=args.max_new_cap,
            prompt_extra=args.prompt_buckets, lora_rank=lora_rank, adapters=adapters,
            prefill_cache=args.prefill_cache, queue_depth=args.queue_depth,
            deadline_s=None, spec_k=spec_k, spec_ks=spec_ks, spec_adaptive=args.spec_adaptive == "on",
            spec_max_slots=args.spec_max_slots, spec_chunk=args.spec_chunk, spec_drafter=args.spec_drafter,
            kv_quant=args.kv_quant == "on", kv_window=_kv_window_enabled(args), metrics=metrics)
        _warm_continuous(batcher, size, args.prompt_buckets, args.n_slots)
        print(f"continuous warm-up complete ({len(args.prompt_buckets)} bucket(s))", file=sys.stderr, flush=True)
    elif args.batch_window_ms > 0:
        batcher = Batcher(engine, args.batch_window_ms, args.max_batch, queue_depth=args.queue_depth)
        batcher.submit({"prompt": "warmup", "image": Image.new("RGB", (size, size)), "max_tokens": 8,
                        "temperature": 0.8, "top_p": 0.9, "do_sample": False})
        print("batched warm-up complete", file=sys.stderr, flush=True)
    else:
        batcher = None
    deadline_s = args.request_timeout_s if args.request_timeout_s > 0 else None
    if batcher is not None:
        batcher.deadline_s = deadline_s
    admission = Admission(depth=args.queue_depth, deadline_s=deadline_s)
    server = ThreadingHTTPServer((host, args.port), make_handler(engine, batcher, admission, metrics))
    return server, engine, batcher


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch

    from paligemma_tpu_torch.lora import ADAPTER_FILES

    for name, path in _adapter_specs(args.adapter):
        if not any(os.path.exists(os.path.join(path, f)) for f in ADAPTER_FILES):
            print(f"error: --adapter {name}={path}: no saved adapter in that directory", file=sys.stderr)
            return 2
    if args.prefill_a8 == "on" and args.quant not in ("int8", "w4a8"):
        print("error: --prefill_a8 on requires --quant int8 or w4a8", file=sys.stderr)
        return 2
    if not args.only_cpu and not torch.cuda.is_available():
        print("error: no CUDA device; pass --only_cpu to run on the CPU", file=sys.stderr)
        return 1
    from inference_torch import load_for_cli

    device = "cpu" if args.only_cpu else "cuda"
    demo = args.demo or not args.model_path
    model, processor = load_for_cli(args.model_path, demo, args.quant, args.prefill_a8 == "on", device)
    name = (args.model_path or "demo-tiny-random") + (f"+{args.quant}" if args.quant != "none" else "")
    server, _, _ = build_server(model, processor, args, name)
    print(f"serving on http://127.0.0.1:{args.port}", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
