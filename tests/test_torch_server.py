"""The port's HTTP/SSE server (`paddle_tpu_torch.serving.ServingServer`)
against the JAX package's, on the CPU.

Both packages serve a tiny GPT built from the same numpy weights
(`from_jax_state_dict`) behind their own `ServingServer` on loopback
(127.0.0.1, ephemeral ports). The same requests go to both: greedy tokens
must be identical per request, streamed (SSE) and not, and status codes
and error reasons equal for a bad body, an unknown adapter, a full wait
queue, a draining server, an unknown route and a wrong method. The
`/metrics` families and the `/healthz` payload keys must match but for an
explicit list of families only the JAX engine has.

The helpers here (`Side`, `make_sides`, `http`, `sse_tokens`) are shared
with the port's other front-door tests (`test_torch_frontend.py`,
`test_torch_supervisor.py`, `test_torch_observability.py`).
"""
import asyncio
import inspect
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jserving
import paddle_tpu_torch.serving as tserving
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.weights import from_jax_state_dict

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)
ENGINE = dict(block_size=8, max_batch=4, max_seq_len=64, prefill_chunk=16)


class Side:
    """One package's serving surface over one model: `serving` is the
    package's `serving` module, `engine(**kw)` builds its LLMEngine with
    the shared defaults (the port's on the CPU)."""

    def __init__(self, name, serving, model):
        self.name = name
        self.serving = serving
        self.faults = serving.faults
        self.model = model

    def engine(self, **kw):
        kw = {**ENGINE, **kw}
        if self.name == "torch":
            kw["device"] = "cpu"
        return self.serving.LLMEngine(self.model, **kw)

    def server(self, engine=None, **kw):
        return self.serving.ServingServer(
            self.engine() if engine is None else engine,
            host="127.0.0.1", port=0, **kw)


def make_sides():
    """{"jax": Side, "torch": Side} over one set of random weights."""
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, attn_impl="xla", dropout=0.0))
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in state_dict_arrays(jm)[0].items()}
    tm = from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"), arrays)
    return {"jax": Side("jax", jserving, jm),
            "torch": Side("torch", tserving, tm)}


def run_both(sides, scenario):
    """{side name: scenario(side)}, JAX first; a coroutine scenario runs
    under `asyncio.run`. A fault plan left armed by a scenario is cleared
    before the next side runs."""
    out = {}
    for name in ("jax", "torch"):
        side = sides[name]
        try:
            res = scenario(side)
            out[name] = asyncio.run(res) if inspect.iscoroutine(res) else res
        finally:
            plan = side.faults.active()
            if plan is not None:
                plan.release_hangs()
            side.faults.clear()
    return out


def prompts(lengths, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, CFG["vocab_size"], (n,)).tolist() for n in lengths]


def idle(engine):
    return engine.pool.num_free == engine.pool.num_blocks - 1


async def wait_for(cond, timeout=30.0, msg="condition"):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {msg}")
        await asyncio.sleep(0.01)


async def http(port, method, path, obj=None):
    """One loopback HTTP exchange: (status, headers dict, body bytes)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(obj).encode() if obj is not None else b""
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(data)}\r\n\r\n").encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionError, OSError):
        pass
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    return int(lines[0].split(" ")[1]), headers, body


def sse_tokens(body):
    """An SSE body -> (tokens, final finish_reason, saw [DONE])."""
    toks, reason, done = [], None, False
    for line in body.decode().splitlines():
        if not line.startswith("data: "):
            continue
        payload = line[len("data: "):]
        if payload == "[DONE]":
            done = True
            continue
        choice = json.loads(payload)["choices"][0]
        toks.extend(choice["token_ids"])
        if choice["finish_reason"] is not None:
            reason = choice["finish_reason"]
    return toks, reason, done


def completion(status, body, stream):
    """(status, tokens, finish_reason) of one /v1/completions answer."""
    if status != 200:
        return status, None, json.loads(body)["error"].get("reason")
    if stream:
        toks, reason, done = sse_tokens(body)
        assert done
        return status, toks, reason
    choice = json.loads(body)["choices"][0]
    return status, choice["token_ids"], choice["finish_reason"]


def prom_families(text):
    """Family names of a Prometheus text exposition (its TYPE lines)."""
    return {m.group(1) for m in re.finditer(r"^# TYPE (\S+) \S+$", text,
                                            re.M)}


@pytest.fixture(scope="module")
def sides():
    return make_sides()


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for mod in (jserving.faults, tserving.faults):
        plan = mod.active()
        if plan is not None:
            plan.release_hangs()
        mod.clear()


WAVE = prompts((5, 9, 21, 30, 12, 3), seed=1)


async def _wave(side):
    """The six prompts at once, even ones streamed, each with its own
    request id, through one server with speculative decoding on."""
    engine = side.engine(spec_decoding=True, num_spec_tokens=3)
    server = side.server(engine)
    await server.start()
    try:
        res = await asyncio.gather(*[
            http(server.port, "POST", "/v1/completions",
                 {"prompt": p, "max_tokens": 10, "stream": i % 2 == 0,
                  "request_id": f"r{i}"})
            for i, p in enumerate(WAVE)])
    finally:
        await server.shutdown(drain=True)
    return ([completion(s, b, i % 2 == 0) for i, (s, _, b) in
             enumerate(res)], idle(engine),
            server.engine._thread.is_alive())


def test_wave_tokens_match_jax_server(sides):
    got = run_both(sides, _wave)
    want, jidle, _ = got["jax"]
    mine, tidle, alive = got["torch"]
    assert [s for s, _, _ in want] == [200] * len(WAVE)
    assert mine == want                  # tokens and reasons, per request
    assert all(r == "length" and len(t) == 10 for _, t, r in mine)
    assert jidle and tidle and not alive


async def _one_by_one(side):
    """Sequential requests, alternating SSE and a full response: the
    tokens of each equal a direct `generate` of the same engine build."""
    server = side.server()
    await server.start()
    out = []
    try:
        for i, p in enumerate(WAVE[:4]):
            s, _, b = await http(server.port, "POST", "/v1/completions",
                                 {"prompt": p, "max_tokens": 6,
                                  "stream": i % 2 == 1})
            out.append(completion(s, b, i % 2 == 1))
    finally:
        await server.shutdown(drain=True)
    direct = side.engine().generate(WAVE[:4], max_new_tokens=6)
    return out, direct


def test_sequential_tokens_match_jax_and_direct_engine(sides):
    got = run_both(sides, _one_by_one)
    assert got["torch"] == got["jax"]
    served, direct = got["torch"]
    assert [t for _, t, _ in served] == direct


async def _statuses(side):
    """Each rejection path's (status, error type, error reason,
    Retry-After)."""
    p = WAVE[0]
    engine = side.engine(max_batch=1)
    server = side.server(engine, max_waiting=0)
    await server.start()
    out = {}

    async def probe(key, method, path, obj=None):
        s, h, b = await http(server.port, method, path, obj)
        err = json.loads(b).get("error", {}) if s != 200 else {}
        out[key] = (s, err.get("type"), err.get("reason"),
                    h.get("retry-after"))

    try:
        await probe("bad_prompt", "POST", "/v1/completions",
                    {"prompt": "not token ids"})
        await probe("bad_number", "POST", "/v1/completions",
                    {"prompt": p, "timeout_s": "soon"})
        await probe("bad_top_p", "POST", "/v1/completions",
                    {"prompt": p, "top_p": "hot"})
        await probe("too_long", "POST", "/v1/completions",
                    {"prompt": p, "max_tokens": 64})
        await probe("adapter", "POST", "/v1/completions",
                    {"prompt": p, "max_tokens": 2, "adapter": "nope"})
        await probe("no_route", "GET", "/nope")
        await probe("get_completions", "GET", "/v1/completions")
        await probe("no_trace", "GET", "/debug/trace")
        await probe("no_slo", "GET", "/debug/slo")
        await probe("no_postmortem", "GET", "/debug/postmortem")
        # one lane, no wait queue: a second request is rejected while the
        # first is in flight
        st = server.engine.submit(p, max_new_tokens=40)
        await probe("overloaded", "POST", "/v1/completions",
                    {"prompt": p, "max_tokens": 2})
        await st.collect()
        server.begin_drain()
        await probe("draining", "POST", "/v1/completions",
                    {"prompt": p, "max_tokens": 2})
        await probe("healthz_draining", "GET", "/healthz")
    finally:
        await server.shutdown(drain=True)
    return out, engine.metrics.counters.get("requests_rejected", 0)


def test_status_codes_and_reasons_match_jax(sides):
    got = run_both(sides, _statuses)
    assert got["torch"] == got["jax"]
    codes, rejected = got["torch"]
    assert codes["overloaded"] == (429, "overloaded", "queue_full", "1")
    assert codes["draining"] == (503, "draining", "draining", "5")
    assert codes["adapter"][:2] == (400, "bad_request")
    assert {codes[k][0] for k in ("bad_prompt", "bad_number", "bad_top_p",
                                  "too_long")} == {400}
    assert codes["no_route"][0] == codes["no_trace"][0] == 404
    assert codes["get_completions"][0] == 405
    assert codes["healthz_draining"][0] == 503
    assert rejected == 1


# /metrics families the JAX engine exports at this scenario and the port's
# does not, each with its reason. Empty: the features only the JAX engine
# has (the host KV tier's, LoRA's and tensor parallelism's series) are off
# here on both sides, and the port exports every other family.
JAX_ONLY_FAMILIES = {}


async def _surfaces(side):
    """/metrics families, /healthz keys and mesh after one request on an
    engine with tracing, the SLO ledger and a policy on."""
    engine = side.engine(trace=1.0, slo=True, policy=True)
    server = side.server(engine)
    await server.start()
    try:
        await http(server.port, "POST", "/v1/completions",
                   {"prompt": WAVE[1], "max_tokens": 4, "tenant": "a",
                    "priority": "standard"})
        ms, _, mb = await http(server.port, "GET", "/metrics")
        hs, _, hb = await http(server.port, "GET", "/healthz")
    finally:
        await server.shutdown(drain=True)
    health = json.loads(hb)
    return (ms, hs, prom_families(mb.decode()), sorted(health),
            sorted(health["pool"]), health["mesh"],
            sorted(health["lifecycle"]), sorted(health["gauges"]))


def test_metrics_and_healthz_surfaces_match_jax(sides):
    got = run_both(sides, _surfaces)
    jms, jhs, jfam, *jrest = got["jax"]
    tms, ths, tfam, *trest = got["torch"]
    assert jms == tms == 200 and jhs == ths == 200
    assert tfam == jfam - set(JAX_ONLY_FAMILIES)
    assert trest == jrest
    assert trest[2] == {"tp_degree": 1, "device_count": 1,
                        "backend": "cpu", "kv_dtype": "float32"}
    for fam in ("lifecycle_state", "mesh_tp_degree", "slo_ttft_seconds",
                "mixed_step_seconds"):
        assert f"paddle_tpu_serving_{fam}" in tfam


async def _disconnect(side):
    """A client that drops its SSE stream mid-request: the request is
    aborted and its blocks return to the pool. Slowed steps keep the
    request in flight until the disconnect lands."""
    side.faults.install(side.faults.FaultPlan(
        [{"point": "slow_step_ms", "ms": 5.0}]))
    engine = side.engine()
    server = side.server(engine)
    await server.start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       server.port)
        data = json.dumps({"prompt": WAVE[2], "max_tokens": 40,
                           "stream": True}).encode()
        writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                      f"Content-Length: {len(data)}\r\n\r\n").encode()
                     + data)
        await writer.drain()
        while not (await reader.readline()).startswith(b"data: "):
            pass
        writer.close()
        await wait_for(lambda: engine.metrics.counters.get(
            "requests_cancelled", 0) >= 1 and idle(engine),
            msg="disconnect abort")
    finally:
        await server.shutdown(drain=True)
    c = engine.metrics.counters
    return c["client_disconnects"], c["requests_cancelled"], idle(engine)


def test_client_disconnect_aborts_like_jax(sides):
    got = run_both(sides, _disconnect)
    assert got["torch"] == got["jax"] == (1, 1, True)


def test_server_cli_refuses_fleet_options_and_needs_a_card(monkeypatch):
    from paddle_tpu_torch.serving.server import main

    for argv in (["--replicas", "2"], ["--autoscale-max", "3"],
                 ["--tp-degree", "2"], ["--checkpoint", "ckpt"],
                 ["--param-hbm-bytes", "1000"]):
        with pytest.raises(NotImplementedError, match="Queue 1 item"):
            main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--port", "0"])


def test_server_cli_serves_on_the_cpu():
    """`python -m paddle_tpu_torch.serving.server --device cpu` boots,
    answers a completion and drains on SIGINT."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_TPU_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.server",
         "--device", "cpu", "--port", "0", "--max-seq-len", "64"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        port = int(re.search(r":(\d+) \(", line).group(1))
        status, _, body = asyncio.run(http(
            port, "POST", "/v1/completions",
            {"prompt": [1, 2, 3], "max_tokens": 3}))
        assert status == 200
        assert len(json.loads(body)["choices"][0]["token_ids"]) == 3
        assert "on cpu" in line
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, proc.stderr.read()
