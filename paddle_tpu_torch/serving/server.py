"""HTTP serving frontend: OpenAI-style completions over AsyncLLMEngine.

Stdlib-only (asyncio + hand-rolled HTTP/1.1), one process, loopback-
friendly for tests: the JAX package's servers over the port's engines.
Two servers share one HTTP base (`_HTTPServerBase`): `ServingServer`
fronts ONE engine (an `AsyncLLMEngine`), `RouterServer` fronts a replica
fleet (`serving/router.py`'s `ReplicaRouter`: prefix-affinity routing,
health-aware ejection, retry-elsewhere, rolling drain; with an optional
`AutoScaler`). Endpoints:

- ``POST /v1/completions`` — OpenAI-style body. ``prompt`` is a list of
  token ids (no tokenizer ships with the repo; ``token_ids`` come back in
  every choice and ``text`` is the space-joined ids). Sampling knobs:
  ``temperature`` (0 = greedy), ``top_k``, ``top_p``; speculative-decoding
  overrides ``spec_decoding`` / ``num_spec_tokens`` apply when the engine
  was built with it enabled. ``stream: true`` sends server-sent events,
  one token per ``data:`` chunk, terminated by ``data: [DONE]``.
  Admission control maps onto status codes: 429 when the bounded wait
  queue is full (`EngineOverloadedError`, with ``Retry-After``), 503
  while draining (`EngineClosedError`), 400 on invalid requests (an
  ``adapter`` the engine has not loaded included; a loaded one decodes the
  request through that LoRA adapter). A client
  that disconnects mid-request is detected (EOF on its socket) and its
  request is aborted — KV blocks return to the pool while the engine
  keeps serving everyone else.
- ``GET /healthz`` — the health word derived once in
  `AsyncLLMEngine.healthz_state`: 200 ``{"status": "ok"}`` with in-flight
  gauges, the lifecycle, mesh topology, pool saturation
  (`LLMEngine.pool_stats`) and the supervisor's poison window; 503
  ``draining`` / ``unhealthy`` (with its reason, e.g. ``step_stuck``) /
  ``engine_dead``. 429/503 rejections from `/v1/completions` carry a
  structured ``error.reason``.
- ``GET /metrics`` — Prometheus text exposition from ServingMetrics.
- ``GET /debug/trace`` — the engine's lifecycle/step trace as
  Chrome/Perfetto trace-event JSON; 404 with a hint unless tracing is on
  (``PADDLE_TPU_TRACE=1`` or ``LLMEngine(trace=...)``).
- ``GET /debug/slo`` — the SLO ledger's per-(tenant, priority) rollup;
  404 unless the ledger is on (``PADDLE_TPU_SLO=1`` /
  ``LLMEngine(slo=True)`` / request log / flight recorder). Bodies may
  carry ``tenant`` (alias ``user``) and ``priority``; ``timeout_s``
  doubles as the deadline.
- ``GET /debug/postmortem`` — manifests of the flight recorder's bundles;
  404 unless ``PADDLE_TPU_POSTMORTEM_DIR`` / ``postmortem_dir=`` is set.
- ``GET /debug/kvtier`` — the host KV tier's snapshot (stats, resident
  hashes, slab geometry); 404 with a hint unless the tier is on
  (``LLMEngine(host_kv_blocks=N)`` / ``PADDLE_TPU_HOST_KV_BLOCKS=N``). On
  the RouterServer, one snapshot per replica keyed by its name.
- ``GET /debug/router`` (RouterServer only) — every replica's state
  machine and healthz word, recent lifecycle events (ejections, probes,
  restarts, drains, migrations) and the routing knobs.
- ``GET /debug/autoscale`` (RouterServer only) — the autoscaler's knobs,
  streaks, cooldown and decision log; 404 with a hint unless an
  `AutoScaler` is attached (``--autoscale-max N`` on the CLI).

On the RouterServer, ``/healthz`` reports the fleet (200 while at least
one replica is in rotation, every replica's state and healthz word),
``/metrics`` the router's series (plus the autoscaler's) and
``/debug/slo`` the fleet rollup (`SLOLedger.merged_rollup`).

`ServingServer.shutdown(drain=True)` is the graceful path: the listener
closes, the engine stops admitting and finishes or aborts in-flight work,
open SSE streams run to their natural end, then the server exits.
``python -m paddle_tpu_torch.serving.server`` boots a server around a
randomly initialized GPT on the card (``--device cpu`` for tests);
``--replicas N`` boots the fleet router instead, and ``--checkpoint DIR``
streams every replica's weights from a checkpoint.
"""
from __future__ import annotations

import asyncio
import json
import time

from .frontend import AsyncLLMEngine, EngineClosedError, EngineOverloadedError

_MAX_HEAD = 64 * 1024
_MAX_BODY = 8 * 1024 * 1024


def _http_response(status, body, content_type="application/json",
                   extra_headers=()):
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    elif isinstance(body, str):
        body = body.encode()
    head = [f"HTTP/1.1 {status}"]
    head.append(f"Content-Type: {content_type}")
    head.append(f"Content-Length: {len(body)}")
    head.append("Connection: close")
    head.extend(extra_headers)
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _error_body(status, message, err_type, reason=None):
    err = {"message": message, "type": err_type, "code": status}
    if reason is not None:
        # machine-readable backoff hint: queue_full / kv_capacity /
        # deadline_unattainable (429 — back off, retry) vs draining /
        # unhealthy / engine_dead (503 — a load balancer should send
        # the traffic elsewhere)
        err["reason"] = reason
    return {"error": err}


def _retry_after(exc, default=None):
    """``Retry-After`` header tuple for an admission rejection, or ()."""
    s = getattr(exc, "retry_after_s", None) or default
    if s is None:
        return ()
    return (f"Retry-After: {max(1, int(round(s)))}",)


def _parse_completion_spec(body):
    """Parse an OpenAI-style ``/v1/completions`` body into canonical
    submit kwargs plus ``stream``.
    Raises ValueError/TypeError on a bad request (HTTP 400)."""
    spec = json.loads(body or b"{}")
    if not isinstance(spec, dict):
        raise ValueError("body must be a JSON object")
    prompt = spec.get("prompt", spec.get("prompt_token_ids"))
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) for t in prompt)):
        raise ValueError(
            "'prompt' must be a non-empty list of token ids "
            "(no tokenizer ships with the server)"
        )
    kw = {"prompt_ids": prompt,
          "max_new_tokens": int(spec.get("max_tokens", 16)),
          "temperature": float(spec.get("temperature", 0.0))}
    top_k = spec.get("top_k")
    kw["top_k"] = None if top_k is None else int(top_k)
    top_p = spec.get("top_p")
    kw["top_p"] = None if top_p is None else float(top_p)
    spec_decoding = spec.get("spec_decoding")
    kw["spec_decoding"] = (None if spec_decoding is None
                           else bool(spec_decoding))
    num_spec = spec.get("num_spec_tokens")
    kw["num_spec_tokens"] = None if num_spec is None else int(num_spec)
    eos = spec.get("eos_token_id", spec.get("stop_token_id"))
    kw["eos_token_id"] = None if eos is None else int(eos)
    timeout_s = spec.get("timeout_s")
    kw["timeout_s"] = None if timeout_s is None else float(timeout_s)
    request_id = spec.get("request_id")
    # client-supplied correlation id (shows up in traces, the request
    # log, and fault-plan pins); duplicates are 400s
    kw["request_id"] = None if request_id is None else str(request_id)
    trace = spec.get("trace")
    kw["trace"] = None if trace is None else bool(trace)
    # SLO accounting dimensions (serving/slo.py): `tenant` (the
    # OpenAI-style `user` field is accepted as an alias) and `priority`
    # label the request's class in /debug/slo and the slo_* metrics;
    # the effective timeout_s is its deadline
    tenant = spec.get("tenant", spec.get("user"))
    kw["tenant"] = None if tenant is None else str(tenant)
    priority = spec.get("priority")
    kw["priority"] = None if priority is None else str(priority)
    # LoRA adapter selector: the request decodes through this loaded
    # adapter (engine.load_adapter); unknown names are 400s via
    # validate()'s ValueError before the request reaches the engine
    adapter = spec.get("adapter")
    kw["adapter"] = None if adapter is None else str(adapter)
    return kw, bool(spec.get("stream", False))


class _HTTPServerBase:
    """Shared stdlib HTTP/1.1 plumbing: connection handling, the
    completions request/response cycle (SSE + non-streaming, disconnect
    detection, status-code mapping), lifecycle. Subclasses provide the
    backend through four hooks: `_start_backend`, `_submit(kw)` (returns
    an async token stream with `finish_reason`/`error`/`request_id`),
    `_abort_stream(st)`, and `_backend_metrics`."""

    def __init__(self, host="127.0.0.1", port=0,
                 model_name="paddle-tpu-gpt"):
        self.host = host
        self.port = int(port)
        self.model_name = model_name
        self._server = None
        self._draining = False

    # -- lifecycle ---------------------------------------------------------

    async def start(self):
        await self._start_backend()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, limit=_MAX_HEAD
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def serve_forever(self):
        async with self._server:
            await self._server.serve_forever()

    async def shutdown(self, drain=True, timeout_s=30.0):
        """Graceful: stop accepting, drain (or abort) the backend, let
        open streams finish, close. Safe to call twice."""
        self._draining = True
        if self._server is not None:
            self._server.close()
        await self._shutdown_backend(drain=drain, timeout_s=timeout_s)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    # -- connection handling ----------------------------------------------

    async def _handle(self, reader, writer):
        try:
            try:
                head = await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"), timeout=30.0
                )
            except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                    asyncio.TimeoutError, ConnectionError):
                return
            request_line, _, rest = head.decode("latin1").partition("\r\n")
            parts = request_line.split(" ")
            if len(parts) != 3:
                writer.write(_http_response(
                    "400 Bad Request",
                    _error_body(400, "malformed request line", "bad_request"),
                ))
                return
            method, path = parts[0].upper(), parts[1].split("?", 1)[0]
            headers = {}
            for line in rest.split("\r\n"):
                name, sep, value = line.partition(":")
                if sep:
                    headers[name.strip().lower()] = value.strip()
            body = b""
            try:
                length = int(headers.get("content-length", 0) or 0)
            except ValueError:
                writer.write(_http_response(
                    "400 Bad Request",
                    _error_body(400, "bad Content-Length", "bad_request"),
                ))
                return
            if length:
                if length > _MAX_BODY:
                    writer.write(_http_response(
                        "413 Payload Too Large",
                        _error_body(413, "body too large", "bad_request"),
                    ))
                    return
                body = await asyncio.wait_for(
                    reader.readexactly(length), timeout=30.0
                )
            await self._route(method, path, body, reader, writer)
        except (ConnectionError, asyncio.TimeoutError,
                asyncio.IncompleteReadError):
            pass  # client stalled or went away mid-request — drop it
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    # -- /v1/completions ---------------------------------------------------

    async def _completions(self, body, reader, writer):
        try:
            kw, stream = _parse_completion_spec(body)
        except (ValueError, TypeError) as e:
            writer.write(_http_response(
                "400 Bad Request", _error_body(400, str(e), "bad_request")
            ))
            return await writer.drain()
        prompt_len = len(kw["prompt_ids"])
        try:
            st = await self._submit(kw)
        except EngineOverloadedError as e:
            writer.write(_http_response(
                "429 Too Many Requests",
                _error_body(429, str(e), "overloaded",
                            reason=getattr(e, "reason", "queue_full")),
                extra_headers=_retry_after(e, default=1.0),
            ))
            return await writer.drain()
        except EngineClosedError as e:
            reason = getattr(e, "reason", "draining")
            writer.write(_http_response(
                "503 Service Unavailable",
                # type doubles as the reason (back-compat: clients match
                # on "draining"); reason is the canonical field
                _error_body(503, str(e), reason, reason=reason),
                extra_headers=_retry_after(e),
            ))
            return await writer.drain()
        except ValueError as e:
            writer.write(_http_response(
                "400 Bad Request", _error_body(400, str(e), "bad_request")
            ))
            return await writer.drain()
        rid = f"cmpl-{st.request_id}"
        # the monitor task sees EOF the moment the client goes away — even
        # while we are parked waiting for tokens — and turns the disconnect
        # into an engine abort that frees the request's KV blocks. Stray
        # inbound bytes (trailing CRLF, an optimistic pipelined request —
        # we answer Connection: close) are drained, NOT treated as a hangup
        monitor = asyncio.ensure_future(self._watch_eof(reader))
        work = asyncio.ensure_future(
            self._stream_sse(st, rid, prompt_len, writer) if stream
            else self._respond_full(st, rid, prompt_len, writer)
        )
        done, _ = await asyncio.wait(
            {monitor, work}, return_when=asyncio.FIRST_COMPLETED
        )
        if work not in done:
            self._abort_stream(st)
            self._backend_metrics.inc("client_disconnects")
        await work
        monitor.cancel()
        try:
            await monitor
        except (asyncio.CancelledError, ConnectionError, OSError):
            pass

    @staticmethod
    async def _watch_eof(reader):
        while await reader.read(4096):
            pass

    def _chunk(self, rid, token_ids, finish_reason):
        return {
            "id": rid,
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{
                "index": 0,
                "text": " ".join(str(t) for t in token_ids),
                "token_ids": list(token_ids),
                "finish_reason": finish_reason,
            }],
        }

    async def _stream_sse(self, st, rid, prompt_tokens, writer):
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n"
        )
        n = 0
        try:
            await writer.drain()
            async for tok in st:
                n += 1
                payload = json.dumps(self._chunk(rid, [tok], None))
                writer.write(f"data: {payload}\n\n".encode())
                await writer.drain()
            final = self._chunk(rid, [], st.finish_reason)
            final["usage"] = {
                "prompt_tokens": prompt_tokens, "completion_tokens": n,
                "total_tokens": prompt_tokens + n,
            }
            writer.write(f"data: {json.dumps(final)}\n\ndata: [DONE]\n\n"
                         .encode())
            await writer.drain()
        except ConnectionError:
            # client went away mid-stream; the monitor (or this) aborts
            self._abort_stream(st)

    async def _respond_full(self, st, rid, prompt_tokens, writer):
        toks, reason = await st.collect()
        if reason == "error":
            writer.write(_http_response(
                "500 Internal Server Error",
                _error_body(500, st.error or "engine error", "engine_error"),
            ))
            return await writer.drain()
        out = self._chunk(rid, toks, reason)
        out["usage"] = {
            "prompt_tokens": prompt_tokens, "completion_tokens": len(toks),
            "total_tokens": prompt_tokens + len(toks),
        }
        try:
            writer.write(_http_response("200 OK", out))
            await writer.drain()
        except ConnectionError:
            pass


class ServingServer(_HTTPServerBase):
    def __init__(self, engine, host="127.0.0.1", port=0,
                 model_name="paddle-tpu-gpt", max_waiting=64,
                 stream_queue_size=64, default_timeout_s=None,
                 watchdog_step_timeout_s=None, max_step_retries=3,
                 max_kv_commit_blocks=None):
        super().__init__(host=host, port=port, model_name=model_name)
        if isinstance(engine, AsyncLLMEngine):
            if (max_waiting != 64 or stream_queue_size != 64
                    or default_timeout_s is not None
                    or watchdog_step_timeout_s is not None
                    or max_step_retries != 3
                    or max_kv_commit_blocks is not None):
                raise ValueError(
                    "max_waiting/stream_queue_size/default_timeout_s/"
                    "watchdog_step_timeout_s/max_step_retries/"
                    "max_kv_commit_blocks belong to the AsyncLLMEngine "
                    "you passed — set them there"
                )
        else:
            engine = AsyncLLMEngine(
                engine, max_waiting=max_waiting,
                stream_queue_size=stream_queue_size,
                default_timeout_s=default_timeout_s,
                watchdog_step_timeout_s=watchdog_step_timeout_s,
                max_step_retries=max_step_retries,
                max_kv_commit_blocks=max_kv_commit_blocks,
            )
        self.engine = engine

    # -- backend hooks -----------------------------------------------------

    async def _start_backend(self):
        await self.engine.start()

    async def _submit(self, kw):
        return self.engine.submit(**kw)

    def _abort_stream(self, st):
        self.engine.abort(st.request_id)

    @property
    def _backend_metrics(self):
        return self.engine.metrics

    # -- lifecycle ---------------------------------------------------------

    def begin_drain(self):
        """Stop admitting while the listener stays up: `/healthz` flips to
        503 (so a load balancer pulls this replica) and `/v1/completions`
        rejects with 503, but in-flight streams keep running. Call
        `shutdown()` to finish the drain and close."""
        self._draining = True
        self.engine.stop_admitting()

    async def _shutdown_backend(self, drain, timeout_s):
        await self.engine.shutdown(drain=drain, timeout_s=timeout_s)

    # -- routes ------------------------------------------------------------

    async def _route(self, method, path, body, reader, writer):
        if path == "/healthz":
            return await self._healthz(writer)
        if path == "/metrics":
            # pool-saturation gauges (the /healthz split: truly-free vs
            # cached-free vs allocated blocks, running/waiting) refresh
            # from the live engine at scrape time so dashboards never need
            # to scrape a non-Prometheus endpoint — plain int reads,
            # GIL-consistent, no engine-thread handshake. The poison
            # window refreshes its gauges the same way (they must decay
            # with the window, not freeze at the last isolation).
            m = self.engine.metrics
            for k, v in self.engine.engine.pool_stats().items():
                # kv_dtype is a string — it rides the `kv` info family
                # (and /healthz), not the numeric pool_* gauges
                if isinstance(v, (int, float)):
                    m.set_gauge(f"pool_{k}", v)
            self.engine.supervisor.poison_stats()
            writer.write(_http_response(
                "200 OK", m.prometheus_text(),
                content_type="text/plain; version=0.0.4; charset=utf-8",
            ))
            return await writer.drain()
        if path == "/debug/slo":
            ledger = getattr(self.engine.engine, "slo", None)
            if ledger is None:
                writer.write(_http_response(
                    "404 Not Found",
                    _error_body(
                        404,
                        "the SLO ledger is off — start the engine with "
                        "PADDLE_TPU_SLO=1 (or LLMEngine(slo=True)) for "
                        "per-class latency attribution rollups",
                        "not_found"),
                ))
                return await writer.drain()
            # rollup copies + sorts the per-class percentile windows —
            # off the event loop so a scrape can't stall live SSE
            # streams (the /debug/trace and /debug/postmortem
            # discipline; rollup itself is thread-safe)
            body = await asyncio.to_thread(ledger.rollup)
            writer.write(_http_response("200 OK", body))
            return await writer.drain()
        if path == "/debug/postmortem":
            rec = getattr(self.engine.engine, "recorder", None)
            if rec is None:
                writer.write(_http_response(
                    "404 Not Found",
                    _error_body(
                        404,
                        "the flight recorder is off — set "
                        "PADDLE_TPU_POSTMORTEM_DIR (or "
                        "LLMEngine(postmortem_dir=...)) to write "
                        "postmortem bundles on fault events",
                        "not_found"),
                ))
                return await writer.drain()
            # disk reads off the event loop: a slow volume must never
            # stall live SSE streams (the /debug/trace discipline)
            body = await asyncio.to_thread(
                lambda: json.dumps({"dir": rec.dir, "keep": rec.keep,
                                    "bundles": rec.list_bundles()}).encode())
            writer.write(_http_response("200 OK", body))
            return await writer.drain()
        if path == "/debug/trace":
            tracer = getattr(self.engine.engine, "tracer", None)
            if tracer is None:
                writer.write(_http_response(
                    "404 Not Found",
                    _error_body(
                        404,
                        "tracing is off — start the engine with "
                        "PADDLE_TPU_TRACE=1 (or LLMEngine(trace=...)) to "
                        "record a lifecycle/step trace", "not_found"),
                ))
                return await writer.drain()
            # a full ring is a multi-MB payload: snapshot + serialize OFF
            # the event loop so a mid-serve scrape never stalls live SSE
            # streams or disconnect detection
            body = await asyncio.to_thread(
                lambda: json.dumps(tracer.chrome_trace()).encode())
            writer.write(_http_response("200 OK", body))
            return await writer.drain()
        if path == "/debug/kvtier":
            tier = getattr(self.engine.engine, "tier", None)
            if tier is None:
                writer.write(_http_response(
                    "404 Not Found",
                    _error_body(
                        404,
                        "the host KV tier is off — start the engine with "
                        "LLMEngine(host_kv_blocks=N) (or "
                        "PADDLE_TPU_HOST_KV_BLOCKS=N) to spill evicted "
                        "cache blocks to a host slab", "not_found"),
                ))
                return await writer.drain()
            # the snapshot takes the tier lock (shared with the engine
            # thread's flush path and the drain thread's slab writes):
            # off the event loop so a scrape can't stall live SSE streams
            body = await asyncio.to_thread(
                lambda: json.dumps(tier.debug_snapshot()).encode())
            writer.write(_http_response("200 OK", body))
            return await writer.drain()
        if path == "/v1/completions":
            if method != "POST":
                writer.write(_http_response(
                    "405 Method Not Allowed",
                    _error_body(405, "use POST", "bad_request"),
                ))
                return await writer.drain()
            return await self._completions(body, reader, writer)
        writer.write(_http_response(
            "404 Not Found", _error_body(404, f"no route {path}", "not_found")
        ))
        await writer.drain()

    async def _healthz(self, writer):
        # the ONE health derivation (frontend.healthz_state):
        # engine_dead > unhealthy > draining
        # > ok; the server's own listener drain adds to "draining"
        state, health = self.engine.healthz_state()
        if state == "ok" and self._draining:
            state = "draining"
        status = "200 OK" if state == "ok" else "503 Service Unavailable"
        payload = {
            "status": state,
            "inflight": self.engine.inflight,
            # engine birth/death phase (serving/lifecycle.py): cold /
            # loading / warm / serving / draining / stopped plus the
            # warmed flag (program table precompiled) and recent
            # transition history
            "lifecycle": self.engine.lifecycle_snapshot(),
            # mesh topology (tp_degree / device_count / backend) is
            # visible to the LB/operator
            # without log-diving; /metrics exposes the same facts as
            # mesh_* gauges + mesh_info, and the two must agree
            "mesh": self.engine.engine.mesh_info(),
            # saturation without a /metrics scrape: block-pool occupancy
            # split by tier + scheduler queue depths (plain ints read off
            # the live engine — GIL-consistent, no engine-thread handshake)
            "pool": self.engine.engine.pool_stats(),
            # the poison-isolation window (supervisor.poison_stats):
            # attributions that span many DISTINCT sources point at a
            # sick card, not a bad client
            "poison": self.engine.supervisor.poison_stats(),
            "gauges": {
                k: v for k, v in dict(self.engine.metrics.gauges).items()
                if isinstance(v, (int, float))
            },
        }
        if not health["healthy"]:
            payload["reason"] = health.get("reason")
            payload.update(
                {k: v for k, v in health.items()
                 if k not in ("healthy", "reason")})
        writer.write(_http_response(status, payload))
        await writer.drain()


class RouterServer(_HTTPServerBase):
    """The fleet surface: ``/v1/completions`` routes through a
    `ReplicaRouter` (prefix affinity, ejection, retry-elsewhere),
    ``/healthz`` reports every replica's state machine, ``/metrics``
    exposes the router's own series, ``/debug/slo`` merges the replicas'
    SLO ledgers into one fleet rollup, and ``/debug/router`` dumps the
    routing table + lifecycle event log. Pass an `AutoScaler`
    (serving/autoscale.py) and the server owns its control loop too:
    started after the router, stopped before it drains, decisions at
    ``/debug/autoscale``."""

    def __init__(self, router, host="127.0.0.1", port=0,
                 model_name="paddle-tpu-gpt", autoscaler=None):
        super().__init__(host=host, port=port, model_name=model_name)
        self.router = router
        self.autoscaler = autoscaler

    # -- backend hooks -----------------------------------------------------

    async def _start_backend(self):
        await self.router.start()
        if self.autoscaler is not None:
            await self.autoscaler.start()

    async def _submit(self, kw):
        return await self.router.submit(**kw)

    def _abort_stream(self, st):
        st.abort()

    @property
    def _backend_metrics(self):
        return self.router.metrics

    # -- lifecycle ---------------------------------------------------------

    def begin_drain(self):
        """Stop admitting fleet-wide while in-flight streams finish (the
        LB drain pattern, one level up). For a zero-downtime RESTART use
        `router.rolling_drain()` instead — it never rejects anybody."""
        self._draining = True
        self.router.stop_admitting()

    async def _shutdown_backend(self, drain, timeout_s):
        # the control loop stops FIRST: a scale decision landing while
        # the fleet drains would fight the shutdown
        if self.autoscaler is not None:
            await self.autoscaler.stop()
        await self.router.shutdown(drain=drain, timeout_s=timeout_s)

    # -- routes ------------------------------------------------------------

    async def _route(self, method, path, body, reader, writer):
        if path == "/healthz":
            return await self._healthz(writer)
        if path == "/metrics":
            self.router.refresh_metrics()
            text = self.router.metrics.prometheus_text()
            if self.autoscaler is not None:
                # autoscale_* series ride the same scrape (names are
                # disjoint from the router_* families, so plain
                # concatenation is a valid exposition)
                text += self.autoscaler.metrics.prometheus_text()
            writer.write(_http_response(
                "200 OK", text,
                content_type="text/plain; version=0.0.4; charset=utf-8",
            ))
            return await writer.drain()
        if path == "/debug/autoscale":
            if self.autoscaler is None:
                writer.write(_http_response(
                    "404 Not Found",
                    _error_body(
                        404,
                        "the autoscaler is off — construct an AutoScaler "
                        "(serving/autoscale.py) and pass it to "
                        "RouterServer(autoscaler=...), or boot with "
                        "--autoscale-max N, for the SLO-driven replica "
                        "control loop and its decision log", "not_found"),
                ))
                return await writer.drain()
            writer.write(_http_response(
                "200 OK", self.autoscaler.snapshot()))
            return await writer.drain()
        if path == "/debug/router":
            writer.write(_http_response("200 OK", self.router.snapshot()))
            return await writer.drain()
        if path == "/debug/slo":
            from .slo import SLOLedger

            ledgers = [r.engine.engine.slo for r in self.router.replicas
                       if r.engine.engine.slo is not None]
            if not ledgers:
                writer.write(_http_response(
                    "404 Not Found",
                    _error_body(
                        404,
                        "no replica runs the SLO ledger — build the "
                        "replica engines with PADDLE_TPU_SLO=1 (or "
                        "LLMEngine(slo=True)) for the fleet rollup",
                        "not_found"),
                ))
                return await writer.drain()
            # merged rollup copies + sorts every replica's percentile
            # windows — off the event loop (the /debug/slo discipline)
            body = await asyncio.to_thread(
                lambda: SLOLedger.merged_rollup(ledgers))
            writer.write(_http_response("200 OK", body))
            return await writer.drain()
        if path == "/debug/kvtier":
            pairs = [(r.name, getattr(r.engine.engine, "tier", None))
                     for r in self.router.replicas]
            if not any(t is not None for _, t in pairs):
                writer.write(_http_response(
                    "404 Not Found",
                    _error_body(
                        404,
                        "no replica runs the host KV tier — build the "
                        "replica engines with LLMEngine(host_kv_blocks=N) "
                        "(or PADDLE_TPU_HOST_KV_BLOCKS=N) for the fleet "
                        "view", "not_found"),
                ))
                return await writer.drain()
            # each snapshot takes that replica's tier lock — off the
            # event loop (the /debug/slo discipline)
            body = await asyncio.to_thread(lambda: json.dumps({
                name: (None if t is None else t.debug_snapshot())
                for name, t in pairs}).encode())
            writer.write(_http_response("200 OK", body))
            return await writer.drain()
        if path == "/v1/completions":
            if method != "POST":
                writer.write(_http_response(
                    "405 Method Not Allowed",
                    _error_body(405, "use POST", "bad_request"),
                ))
                return await writer.drain()
            return await self._completions(body, reader, writer)
        writer.write(_http_response(
            "404 Not Found", _error_body(404, f"no route {path}", "not_found")
        ))
        await writer.drain()

    async def _healthz(self, writer):
        snap = self.router.snapshot()
        active = sum(1 for r in snap["replicas"] if r["state"] == "active")
        if self._draining:
            status, state = "503 Service Unavailable", "draining"
        elif active:
            status, state = "200 OK", "ok"
        else:
            # the whole fleet is out of rotation: nothing can serve
            status, state = "503 Service Unavailable", "unavailable"
        self.router.refresh_metrics()
        payload = {
            "status": state,
            "replicas_active": active,
            "replicas": snap["replicas"],
            "events": snap["events"][-16:],
            "gauges": {
                k: v for k, v in dict(self.router.metrics.gauges).items()
                if isinstance(v, (int, float))
            },
        }
        writer.write(_http_response(status, payload))
        await writer.drain()


def main(argv=None):
    """Demo entry point: ``python -m paddle_tpu_torch.serving.server``
    boots a randomly initialized GPT (seed 0) on the card behind the HTTP
    frontend, or, with ``--checkpoint DIR``, a skeleton whose weights each
    replica streams from that checkpoint. ``--replicas N`` (or
    ``--autoscale-max``) serves N replicas behind the fleet router.
    ``--device cpu`` runs it on the CPU; without it the engines need a
    CUDA device and raise when there is none. ``--tp-degree N`` serves each
    replica over N tensor-parallel ranks placed as the JAX CLI places them,
    over the first N devices (cards ``cuda:0 .. N-1``, or CPU ranks with
    ``--device cpu``); with ``--replicas`` or ``--autoscale-max`` every
    replica spawns its own N - 1 ranks, and a retired, restarted or failed
    replica's ranks end with it. Ranks sharing one card run only over an
    explicit gloo backend, which this CLI does not offer (the JAX CLI has
    no such switch): build such a fleet through the Python API
    (`ServingMesh(devices, backend="gloo")`)."""
    import argparse

    import torch

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default=None,
                   help="device the model and engines run on (default: "
                        "the CUDA card, which must exist; cpu for tests)")
    p.add_argument("--model", default="tiny",
                   choices=("tiny", "small", "1p3b"))
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="the model's parameter dtype (a checkpoint must "
                        "hold the same)")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-seq-len", type=int, default=None)
    p.add_argument("--prefill-chunk", type=int, default=None)
    p.add_argument("--replicas", type=int, default=1,
                   help="serve N engine replicas behind the fleet router "
                        "(serving/router.py): prefix-affinity routing, "
                        "health-aware ejection, retry-elsewhere; 1 = the "
                        "single-replica server")
    p.add_argument("--retry-budget", type=int, default=3,
                   help="router retry budget: backoff rounds + zero-token "
                        "replays per request before the failure is final")
    p.add_argument("--no-affinity", action="store_true",
                   help="disable prefix-affinity routing (least-loaded "
                        "spread only; for A/B benchmarks)")
    p.add_argument("--tp-degree", type=int, default=None,
                   help="tensor-parallel degree of the replica (1: one "
                        "card, which beats PADDLE_TPU_TP)")
    p.add_argument("--kv-hbm-bytes", type=int, default=None,
                   help="size the KV pool from a byte budget instead of "
                        "max_batch * max_seq_len")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="stream every replica's weights leaf by leaf from "
                        "a checkpoint directory (save_sharded_model); the "
                        "model is a skeleton of shapes only")
    p.add_argument("--warmup", action="store_true",
                   help="capture every width-bucket program before "
                        "serving: the first real request builds nothing")
    p.add_argument("--param-hbm-bytes", type=int, default=None,
                   help="per-card parameter budget: engine construction "
                        "fails if the device holds more than this many "
                        "parameter bytes")
    p.add_argument("--autoscale-max", type=int, default=None, metavar="N",
                   help="enable the SLO-driven autoscaler "
                        "(serving/autoscale.py) with at most N replicas; "
                        "implies the fleet router even with --replicas 1")
    p.add_argument("--autoscale-min", type=int, default=1,
                   help="autoscaler floor: never drain below this many "
                        "replicas (default 1)")
    p.add_argument("--autoscale-target-attainment", type=float,
                   default=0.99, metavar="FRAC",
                   help="scale up when any (tenant, priority) class's "
                        "windowed deadline attainment drops below this "
                        "(default 0.99; needs --slo for the signal)")
    p.add_argument("--autoscale-cooldown-s", type=float, default=3.0,
                   help="seconds between scale decisions (hysteresis; "
                        "default 3)")
    p.add_argument("--spawn-ttft-budget-s", type=float, default=None,
                   help="bound on time-to-first-token after a scale-up "
                        "spawn; breaches are counted and flagged in the "
                        "decision log")
    p.add_argument("--max-waiting", type=int, default=64,
                   help="wait-queue bound beyond max_batch lanes (429 past it)")
    p.add_argument("--stream-queue-size", type=int, default=64,
                   help="per-request token queue before backpressure catch-up")
    p.add_argument("--timeout-s", type=float, default=None,
                   help="default per-request deadline (aborts in-flight work)")
    p.add_argument("--watchdog-step-timeout-s", type=float, default=None,
                   help="stuck-step watchdog: a device step running longer "
                        "than this flips /healthz to 503 (step_stuck), "
                        "closes admission, and errors out live streams")
    p.add_argument("--max-step-retries", type=int, default=3,
                   help="consecutive unattributable step failures before "
                        "the supervisor falls back to aborting everything")
    p.add_argument("--max-kv-commit-blocks", type=int, default=None,
                   help="worst-case KV admission gate: reject (429 "
                        "kv_capacity) when admitted requests could need "
                        "more than this many blocks at their longest")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable automatic prefix caching (same as "
                        "PADDLE_TPU_PREFIX_CACHE=0)")
    p.add_argument("--spec-decode", action="store_true",
                   help="enable speculative decoding (prompt-lookup "
                        "drafting + batched verify; same as "
                        "PADDLE_TPU_SPEC_DECODE=1)")
    p.add_argument("--num-spec-tokens", type=int, default=4,
                   help="drafted tokens per decode row when speculative "
                        "decoding is on (sets the spec width bucket)")
    p.add_argument("--trace", type=float, default=None, metavar="FRACTION",
                   help="enable lifecycle/step tracing for this fraction "
                        "of requests (1.0 = all; export at GET "
                        "/debug/trace; same as PADDLE_TPU_TRACE)")
    p.add_argument("--request-log", action="store_true",
                   help="log one JSON summary line per finished/aborted "
                        "request (same as PADDLE_TPU_REQUEST_LOG=1)")
    p.add_argument("--slo", action="store_true",
                   help="enable the SLO attribution ledger: per-request "
                        "phase decomposition, per-tenant/priority "
                        "rollups at GET /debug/slo, and slo_* Prometheus "
                        "histograms (same as PADDLE_TPU_SLO=1)")
    p.add_argument("--postmortem-dir", default=None, metavar="DIR",
                   help="enable the fault flight recorder: write one "
                        "postmortem bundle per supervisor event to DIR, "
                        "listable at GET /debug/postmortem (same as "
                        "PADDLE_TPU_POSTMORTEM_DIR)")
    p.add_argument("--postmortem-keep", type=int, default=None,
                   help="bundles kept before oldest-first pruning "
                        "(default 16; same as PADDLE_TPU_POSTMORTEM_KEEP)")
    args = p.parse_args(argv)

    from .._device import resolve_device
    from ..models.gpt import gpt_1p3b, gpt_small, gpt_tiny
    from .engine import LLMEngine

    build_model = {"tiny": gpt_tiny, "small": gpt_small,
                   "1p3b": gpt_1p3b}[args.model]
    dtype = getattr(torch, args.dtype)
    if args.checkpoint:
        # shapes only: every replica (and every autoscaler spawn) streams
        # its weights from the checkpoint at construction
        from ..nn.layer import skeleton_init

        with skeleton_init():
            model = build_model(dtype=dtype, seed=0)
    else:
        model = build_model(device=args.device, dtype=dtype, seed=0)

    def build_engine():
        return LLMEngine(
            model, device=args.device, block_size=args.block_size,
            max_batch=args.max_batch, max_seq_len=args.max_seq_len,
            prefill_chunk=args.prefill_chunk,
            prefix_cache=False if args.no_prefix_cache else None,
            spec_decoding=True if args.spec_decode else None,
            num_spec_tokens=args.num_spec_tokens, trace=args.trace,
            request_log=True if args.request_log else None,
            slo=True if args.slo else None,
            postmortem_dir=args.postmortem_dir,
            postmortem_keep=args.postmortem_keep,
            # the degree passes through untouched: --tp-degree 1 is an
            # explicit one-card request and beats a PADDLE_TPU_TP default
            # (the engine reads the switch only when mesh is None)
            mesh=args.tp_degree, kv_hbm_bytes=args.kv_hbm_bytes,
            checkpoint_path=args.checkpoint or None,
            param_hbm_bytes=args.param_hbm_bytes, warmup=args.warmup)

    if args.request_log:
        import logging

        logging.basicConfig(level=logging.INFO, format="%(message)s")

    async def run():
        if args.replicas > 1 or args.autoscale_max is not None:
            from .router import ReplicaRouter

            def wrap(engine):
                return AsyncLLMEngine(
                    engine, max_waiting=args.max_waiting,
                    stream_queue_size=args.stream_queue_size,
                    default_timeout_s=args.timeout_s,
                    watchdog_step_timeout_s=args.watchdog_step_timeout_s,
                    max_step_retries=args.max_step_retries,
                    max_kv_commit_blocks=args.max_kv_commit_blocks,
                )

            router = ReplicaRouter(
                [wrap(build_engine()) for _ in range(args.replicas)],
                factory=lambda _i: wrap(build_engine()),
                affinity=not args.no_affinity,
                retry_budget=args.retry_budget,
                default_timeout_s=args.timeout_s,
            )
            autoscaler = None
            if args.autoscale_max is not None:
                from .autoscale import AutoScaler

                autoscaler = AutoScaler(
                    router,
                    min_replicas=args.autoscale_min,
                    max_replicas=args.autoscale_max,
                    target_attainment=args.autoscale_target_attainment,
                    cooldown_s=args.autoscale_cooldown_s,
                    spawn_ttft_budget_s=args.spawn_ttft_budget_s,
                )
            server = RouterServer(router, host=args.host, port=args.port,
                                  autoscaler=autoscaler)
        else:
            server = ServingServer(
                build_engine(), host=args.host, port=args.port,
                max_waiting=args.max_waiting,
                stream_queue_size=args.stream_queue_size,
                default_timeout_s=args.timeout_s,
                watchdog_step_timeout_s=args.watchdog_step_timeout_s,
                max_step_retries=args.max_step_retries,
                max_kv_commit_blocks=args.max_kv_commit_blocks,
            )
        await server.start()
        if args.autoscale_max is not None:
            mode = (f"{args.replicas}-replica router, autoscaling "
                    f"{args.autoscale_min}..{args.autoscale_max}")
        elif args.replicas > 1:
            mode = f"{args.replicas}-replica router"
        else:
            mode = "single replica"
        if (args.tp_degree or 1) > 1:
            mode += f" over {args.tp_degree} tp ranks"
            if args.replicas > 1 or args.autoscale_max is not None:
                mode += " each"
        where = ("weights streamed from " + args.checkpoint
                 if args.checkpoint else "random weights")
        device = resolve_device(args.device)
        print(f"serving on http://{server.host}:{server.port} ({mode} on "
              f"{device}, {where}; POST /v1/completions, GET /healthz, GET "
              "/metrics)", flush=True)
        try:
            await server.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            print("draining...", flush=True)
            await server.shutdown(drain=True)

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
