"""``tensor_llm``, its client and token observability: the PyTorch port
against the JAX package.

The same ``appsrc ! tensor_llm ! tensor_sink`` strings run through both
packages on the CPU in f32, the port's element carrying the JAX model's
weights: every stream (tokens, ``pts``, ``nns_more`` markers, terminal
frames, shed tags) must be identical — dense, paged with whole and with
chunked prefill, and a prefix hit whose copy-on-write tail stays
private.  Over the query wire a port client talks to a JAX server and a
JAX client to a port server.  The port's server sheds on slot
exhaustion, reclaims a disconnected client's slot, drains, serves from
the port's CLI, and its client raises ``TokenTimeoutError`` on a stalled
stream.  ``TokenObs``
gives the JAX package's histograms, blame and records under an injected
clock.  Without a card and without ``device:cpu`` the element refuses to
start.
"""

import gc
import importlib
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models.streamformer_lm import generate as jax_generate
from nnstreamer_tpu.parallel import train_step as JT
from nnstreamer_tpu_torch.device import DeviceError
from nnstreamer_tpu_torch.llm import element as torch_element
from nnstreamer_tpu_torch.models import streamformer_lm as T

SIZES = dict(vocab=61, dim=32, heads=4, head_dim=8, mlp=64, layers=2,
             experts=2, max_seq=48)
CUSTOM = ("vocab:61,dim:32,heads:4,head_dim:8,mlp:64,layers:2,"
          "max_seq:48,dtype:float32,device:cpu")
#: a cache long enough that a stream is still running while something
#: else happens (sheds, disconnects)
CUSTOM_LONG = CUSTOM.replace("max_seq:48", "max_seq:2048")
REQ_CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=24,"
            "types=int32,framerate=0/1")
#: 16-token pages (3 cover max_seq 48); chunks of 4 tokens
CONFIGS = {
    "dense": "slots=3 batch=2",
    "paged_whole": "slots=3 batch=2 page-size=16 prefill-chunk=0",
    "paged_chunked": "slots=3 batch=2 page-size=16 prefill-chunk=4",
}


def _namespace(root: str):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        parse_launch=mod("pipeline").parse_launch,
        TensorBuffer=mod("tensor.buffer").TensorBuffer,
        default_pool=mod("tensor.buffer").default_pool,
        client=mod("llm.client"), tokenobs=mod("llm.tokenobs"),
        engine=mod("llm.engine"), metrics=mod("obs.metrics"),
        server=mod("query.server"), ShedError=mod("query.overload").ShedError)


JAXP = _namespace("nnstreamer_tpu")
PORT = _namespace("nnstreamer_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test files side by side: keep torch's intra-op
    pool off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_JAX_PARAMS = {}


def _jax_params(cfg, seed):
    """The JAX package's weights for the port's config (what its own
    ``tensor_llm`` draws from ``seed``), numpy leaves."""
    sizes = {k: getattr(cfg, k) for k in ("vocab", "dim", "heads",
                                          "head_dim", "mlp", "layers",
                                          "experts", "max_seq")}
    key = (tuple(sizes.values()), seed)
    if key not in _JAX_PARAMS:
        jc = JT.StreamFormerConfig(**sizes, dtype=jnp.float32)
        _JAX_PARAMS[key] = jax.tree_util.tree_map(
            np.asarray, JT.init_params(jc, seed))
    return _JAX_PARAMS[key]


@pytest.fixture(autouse=True)
def jax_weights(monkeypatch):
    """The port's element serves the JAX model's weights."""
    monkeypatch.setattr(
        torch_element, "init_llm_params",
        lambda cfg, seed, device: T.params_from_jax(
            _jax_params(cfg, seed), cfg, device))


def wait_until(cond, timeout=15.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 61, n).astype(np.int32) for n in (13, 5, 17)]


LENS = [6, 8, 5]


def _run_local(ns, props, requests, sequential=False, custom=CUSTOM):
    """``appsrc ! tensor_llm ! tensor_sink`` with one request frame per
    ``(prompt, max_new, stop_token)``; every frame each request got as
    ``(pts, token, more, shed tag)``, and the element's counts."""
    p = ns.parse_launch(
        f"appsrc name=src caps={REQ_CAPS} ! "
        f"tensor_llm name=llm custom={custom} seed=0 {props} ! "
        "tensor_sink name=out")
    frames = {}

    def on_data(b):
        tok = int(np.asarray(b.tensors[0]).reshape(-1)[0])
        frames.setdefault(b.extra.get("tag"), []).append(
            (b.pts, tok, bool(b.extra.get("nns_more")),
             b.extra.get("nns_llm_shed") is not None))
    p.get("out").connect("new-data", on_data)
    p.play()
    for i, (pr, n, stop) in enumerate(requests):
        buf = ns.TensorBuffer(tensors=[ns.client.encode_request(
            pr, max_new=n, stop_token=stop, frame_len=24)])
        buf.extra["tag"] = i
        p.get("src").push_buffer(buf)
        if sequential:
            assert wait_until(lambda i=i: frames.get(i) and not
                              frames[i][-1][2], timeout=120)
    p.get("src").end_of_stream()
    p.wait(timeout=180)
    llm = p.get("llm")
    eng, pool = llm.engine, llm.pool
    counts = {"paged": eng.paged, "chunk": eng.chunk,
              "compiles": eng.compiles, "tokens": eng.tokens_total,
              "prefills": eng.prefills_total,
              "chunks": eng.report().get("prefill_chunks"),
              "cache_bytes": pool.cache_bytes(),
              "sessions": llm.sessions_total, "shed": llm.shed_total,
              "rejected": llm.rejected_total,
              "prefix_hits": getattr(pool, "prefix_hits", 0),
              "reused": getattr(pool, "prefix_tokens_reused", 0),
              "leaks": (pool.check_leaks() if eng.paged else []),
              "free": getattr(pool, "free_pages", None)}
    p.stop()
    return frames, counts


def _both(props, requests, **kw):
    want = _run_local(JAXP, props, requests, **kw)
    got = _run_local(PORT, props, requests, **kw)
    return got, want


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_streams_match_the_jax_element(config):
    """THE contract: sessions joining and leaving a shared decode bucket
    through the element give the JAX element's streams — token, index
    and streaming marker of every frame — which its own tests pin to
    ``generate()``."""
    reqs = [(pr, n, -1) for pr, n in zip(_prompts(), LENS)]
    (got, gcount), (want, wcount) = _both(CONFIGS[config], reqs)
    assert got == want
    for i, n in enumerate(LENS):
        assert [f[0] for f in got[i]] == list(range(n))
        assert [f[2] for f in got[i]] == [True] * (n - 1) + [False]
    assert gcount == wcount
    assert gcount["paged"] == ("paged" in config)


def test_dense_streams_equal_generate():
    jc = JT.StreamFormerConfig(**SIZES, dtype=jnp.float32)
    jparams = _jax_params(jc, 0)
    reqs = [(pr, n, -1) for pr, n in zip(_prompts(), LENS)]
    frames, _ = _run_local(PORT, CONFIGS["dense"], reqs)
    for i, (pr, n, _) in enumerate(reqs):
        assert [f[1] for f in frames[i]] == \
            jax_generate(jparams, jc, pr, n).tolist()


def test_prefix_hit_reuses_pages_and_isolates_tails():
    """Two sessions on one 16-token system prompt, one after the other:
    the second admits onto the first's registered page (16 tokens never
    prefilled again) and both streams equal the JAX element's."""
    pre = (np.arange(16) % 61).astype(np.int32)
    reqs = [(np.concatenate([pre, np.asarray(t, np.int32)]), 6, -1)
            for t in ([3, 9], [44, 1])]
    (got, gcount), (want, wcount) = _both(CONFIGS["paged_chunked"], reqs,
                                          sequential=True)
    assert got == want and gcount == wcount
    assert gcount["prefix_hits"] == 1 and gcount["reused"] == 16
    assert gcount["leaks"] == [] and gcount["free"] == 11


def test_paged_arena_bytes_equal_the_dense_pools():
    reqs = [(np.asarray([5, 6, 7], np.int32), 5, -1)]
    dense = _run_local(PORT, CONFIGS["dense"], reqs)
    paged = _run_local(PORT, CONFIGS["paged_chunked"], reqs)
    assert dense[0] == paged[0]
    assert dense[1]["cache_bytes"] == paged[1]["cache_bytes"]


#: the terminal cases: a stop token met mid-stream (the frame delivered,
#: the stream ended), an over-length prompt (one stop-token frame), a
#: request over the max-new-tokens cap (the cap's tokens and a -1
#: marker) and a slot shed with no server (a tagged stop-token frame)
TERMINAL_CASES = {
    "stop_token": ("slots=2 batch=2", "stop"),
    "over_length": ("slots=2 batch=2", [(np.arange(20, dtype=np.int32), 40,
                                         9)]),
    "over_cap": ("slots=2 batch=2 max-new-tokens=6",
                 [(np.asarray([4, 5], np.int32), 30, -1)]),
    "standalone_shed": ("slots=1 batch=1",
                        [(np.asarray([1, 2], np.int32), 25, -1)] * 2),
}


@pytest.mark.parametrize("case", sorted(TERMINAL_CASES))
def test_terminal_frames_match_the_jax_element(case):
    props, reqs = TERMINAL_CASES[case]
    if reqs == "stop":
        # a token the stream emits mid-way, as its stop token
        first, _ = _run_local(PORT, props,
                              [(np.asarray([3, 1, 4], np.int32), 12, -1)])
        reqs = [(np.asarray([3, 1, 4], np.int32), 12, first[0][4][1])]
    (got, gcount), (want, wcount) = _both(props, reqs)
    assert got == want and gcount == wcount
    if case == "stop_token":
        assert len(got[0]) == 5 and not got[0][-1][2]
    elif case == "over_length":
        assert got == {0: [(0, 9, False, False)]}
        assert gcount["rejected"] == 1 and gcount["sessions"] == 0
    elif case == "over_cap":
        assert [f[1] for f in got[0]][-1] == -1 and len(got[0]) == 7
    else:
        assert gcount["shed"] == 1
        assert sorted(len(v) for v in got.values()) == [1, 25]
        assert [f[3] for v in got.values() for f in v].count(True) == 1


# ---------------------------------------------------------------------------
# over the query wire
# ---------------------------------------------------------------------------

def _serve(ns, sid, props="slots=3 batch=2", custom=CUSTOM):
    p = ns.parse_launch(
        f"tensor_query_serversrc name=qsrc id={sid} port=0 "
        f"caps={REQ_CAPS} ! "
        f"tensor_llm name=llm custom={custom} seed=0 {props} id={sid} ! "
        f"tensor_query_serversink id={sid}")
    p.play()
    return p, p.get("qsrc").bound_port


@pytest.mark.parametrize("server,client", [("jax", "torch"),
                                           ("torch", "jax")])
def test_client_and_server_across_packages(server, client):
    """Concurrent clients of one package against the other package's
    server: every stream complete, in order, and equal to the local JAX
    element's."""
    ns_srv = {"jax": JAXP, "torch": PORT}[server]
    ns_cli = {"jax": JAXP, "torch": PORT}[client]
    sid = 4610 + (server == "torch")
    reqs = [(pr, n, -1) for pr, n in zip(_prompts(), LENS)]
    want, _ = _run_local(JAXP, CONFIGS["dense"], reqs)
    p, port = _serve(ns_srv, sid)
    results = {}

    def run(i):
        cli = ns_cli.client.TokenStreamClient("127.0.0.1", port,
                                              timeout=60.0).connect()
        try:
            pr, n, _ = reqs[i]
            results[i] = cli.generate(pr, n, frame_len=24)
        except Exception as exc:  # noqa: BLE001 - asserted below
            results[i] = repr(exc)
        finally:
            cli.close()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    try:
        assert not any(t.is_alive() for t in threads)
        srv = ns_srv.server.get_server(sid)
        assert wait_until(lambda: srv._inflight == 0, timeout=10)
    finally:
        p.stop()
        ns_srv.server.shutdown_server(sid)
    for i in range(3):
        assert results[i] == [f[1] for f in want[i]], (i, results[i])


SID = 4620


def test_slot_exhaustion_sheds_then_disconnect_reclaims():
    """slots=1: a second concurrent stream gets an explicit T_SHED with a
    retry-after; the first client vanishing mid-stream frees its slot
    (evicted), and every pooled slab comes back — waited for up to a
    stated deadline, since the reader threads release theirs after the
    sockets close."""
    p, port = _serve(PORT, SID, "slots=1 batch=1 max-new-tokens=1500",
                     custom=CUSTOM_LONG)
    llm = p.get("llm")
    try:
        a = PORT.client.TokenStreamClient("127.0.0.1", port,
                                          timeout=60.0).connect()
        b = PORT.client.TokenStreamClient("127.0.0.1", port,
                                          timeout=20.0).connect()
        stream = a.stream(np.asarray([1, 2, 3], np.int32), 1200,
                          frame_len=24)
        next(stream)
        assert wait_until(lambda: llm.pool.live == 1, timeout=10)
        with pytest.raises(PORT.ShedError) as err:
            b.generate(np.asarray([4], np.int32), 5, frame_len=24)
        assert err.value.retry_after_s > 0
        assert llm.shed_total == 1
        a.close()
        b.close()
        assert wait_until(lambda: llm.pool.live == 0, timeout=15)
        assert llm.evicted_total == 1
        srv = PORT.server.get_server(SID)
        assert wait_until(lambda: srv._inflight == 0, timeout=10)
        # the freed slot serves a fresh session correctly
        c = PORT.client.TokenStreamClient("127.0.0.1", port,
                                          timeout=60.0).connect()
        toks = c.generate(np.asarray([2, 4, 6], np.int32), 6, frame_len=24)
        c.close()
        jc = JT.StreamFormerConfig(**{**SIZES, "max_seq": 2048},
                                   dtype=jnp.float32)
        assert toks == jax_generate(
            jax.tree_util.tree_map(jnp.asarray, _jax_params(jc, 0)), jc,
            np.asarray([2, 4, 6], np.int32), 6).tolist()
    finally:
        p.stop()
        PORT.server.shutdown_server(SID)

    def slabs_back():
        gc.collect()
        return PORT.default_pool().stats["pending"] == 0

    assert wait_until(slabs_back, timeout=10)


def test_drain_finishes_streams_and_sheds_new():
    """The element's drain (``Pipeline.drain`` calls it after the
    serversrc's): a request arriving meanwhile is shed through the paired
    server with a retry-after, the resident stream completes, and drain
    returns once no session is left."""
    p, port = _serve(PORT, SID + 1, "slots=2 batch=2 max-new-tokens=1500",
                     custom=CUSTOM_LONG)
    try:
        cli = PORT.client.TokenStreamClient("127.0.0.1", port,
                                            timeout=60.0).connect()
        stream = cli.stream(np.asarray([1, 2], np.int32), 400, frame_len=24)
        got = [next(stream)]
        done = threading.Event()

        llm = p.get("llm")

        def _drain():
            llm.drain(deadline=60.0)
            done.set()

        threading.Thread(target=_drain, daemon=True).start()
        assert wait_until(lambda: llm.pool.admission.draining, timeout=10)
        assert llm.health_state() == "draining"
        late = PORT.client.TokenStreamClient("127.0.0.1", port,
                                             timeout=20.0).connect()
        with pytest.raises(PORT.ShedError) as err:
            late.generate(np.asarray([3], np.int32), 4, frame_len=24)
        assert err.value.retry_after_s > 0
        late.close()
        got.extend(stream)                   # the stream COMPLETES
        assert [i for i, _ in got] == list(range(400))
        assert done.wait(timeout=60)
        assert llm.shed_total == 1 and llm.pool.live == 0
        cli.close()
    finally:
        p.stop()
        PORT.server.shutdown_server(SID + 1)


def test_stalled_stream_raises_token_timeout():
    """A server that accepts the request and never answers: the stream
    raises ``TokenTimeoutError`` at the per-token deadline, not the
    transport's."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    held = []
    threading.Thread(target=lambda: held.append(srv.accept()[0]),
                     daemon=True).start()
    cli = PORT.client.TokenStreamClient("127.0.0.1", srv.getsockname()[1],
                                        timeout=30.0,
                                        token_timeout=0.3).connect()
    t0 = time.monotonic()
    with pytest.raises(PORT.client.TokenTimeoutError) as ei:
        cli.generate(np.asarray([1, 2, 3], np.int32), 8, frame_len=24)
    assert time.monotonic() - t0 < 5.0
    assert ei.value.got == 0 and ei.value.timeout_s == pytest.approx(0.3)
    assert isinstance(ei.value, TimeoutError)
    cli.close()
    for c in held:
        c.close()
    srv.close()


def test_cli_serves_a_tensor_llm_string():
    """``python -m nnstreamer_tpu_torch.launch`` serves a ``tensor_llm``
    string (its own seed-0 weights, on the CPU as asked): a client's
    stream comes back whole, and SIGTERM drains the server to exit 0."""
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    launch = (f"tensor_query_serversrc id=1 port={port} caps={REQ_CAPS} ! "
              f"tensor_llm custom={CUSTOM} seed=0 slots=2 batch=2 id=1 ! "
              "tensor_query_serversink id=1")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.Popen(
        [sys.executable, "-m", "nnstreamer_tpu_torch.launch", launch,
         "--timeout", "120", "--quiet"], cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            assert child.poll() is None, child.stderr.read()
            try:
                cli = PORT.client.TokenStreamClient(
                    "127.0.0.1", port, timeout=5.0).connect()
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.2)
        cli.token_timeout = 60.0
        toks = cli.generate(np.asarray([5, 6, 7], np.int32), 6,
                            frame_len=24)
        cli.close()
        child.send_signal(signal.SIGTERM)
        _, err = child.communicate(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, err
    assert len(toks) == 6 and all(0 <= t < 61 for t in toks)


def test_encode_request_matches_jax():
    for args in (([1, 2, 3], 8, -1, 24), ([7], 1, 5, None)):
        np.testing.assert_array_equal(PORT.client.encode_request(*args),
                                      JAXP.client.encode_request(*args))
    with pytest.raises(ValueError, match="cannot hold"):
        PORT.client.encode_request(np.arange(30), 4, frame_len=24)


# ---------------------------------------------------------------------------
# token observability
# ---------------------------------------------------------------------------

class _Sess:
    def __init__(self, key, qos):
        self.key, self.qos, self.extra, self.obs = key, qos, {}, None


def _tokenobs_script(ns):
    """Admissions, chunks, tokens and terminals of three sessions on an
    injected clock, with the phase clock moving between them: the
    histograms, terminal counters, blame counters and records."""
    now = [0]
    ms = 1_000_000
    reg = ns.metrics.MetricsRegistry()
    clk = ns.engine.PhaseClock(clock_ns=lambda: now[0])
    tobs = ns.tokenobs.TokenObs(clk, clock_ns=lambda: now[0], registry=reg,
                                labels={"element": "llm", "pipeline": "p"})
    a, b, c = _Sess("a", "gold"), _Sess("b", "silver"), _Sess("c", "bronze")
    now[0] = 10 * ms
    tobs.on_admit(a)
    clk.enter("llm-prefill-chunk")
    tobs.on_chunk(a)
    now[0] = 30 * ms
    tobs.on_admit(b)
    clk.enter("decode")
    now[0] = 50 * ms
    tobs.on_token(a)
    tobs.on_token(b)
    clk.enter("compile")
    now[0] = 53 * ms
    clk.enter("egress")
    now[0] = 70 * ms
    tobs.on_token(a)
    tobs.on_refused("silver", "shed")
    tobs.on_refused("gold", "reject")
    tobs.on_admit(c)
    clk.enter("idle")
    now[0] = 100 * ms
    tobs.on_terminal(a, "stop")
    tobs.on_terminal(c, "evict")
    tobs.on_token(b)
    tobs.on_terminal(b, "max_new")
    tobs.sync_blame_counters()
    return (reg.snapshot_state(prefix="nns_llm_"), tobs.records(),
            tobs.blame_report(), tobs.chrome_events(pid=3, offset_ns=5))


def test_tokenobs_matches_jax():
    got, want = _tokenobs_script(PORT), _tokenobs_script(JAXP)
    assert got == want
    recs = {r["key"]: r for r in got[1]}
    assert recs["a"]["ttft_us"] == pytest.approx(40_000.0)
    assert recs["a"]["blame_conserved_pct"] == 100.0
    assert "ttft_us" not in recs["c"]          # evicted before a token
    for name in ("TTFT_US", "ITL_US", "TERMINAL_TOTAL", "BLAME_NS_TOTAL",
                 "PAGES_RECLAIMED_TOTAL", "TERMINAL_CAUSES",
                 "BLAME_CAUSES", "PHASE_BLAME"):
        assert getattr(PORT.tokenobs, name) == getattr(JAXP.tokenobs, name)


def test_default_llm_signals_match_jax():
    for pages in (0, 1151):
        got = [s.report() for s in PORT.tokenobs.default_llm_signals(pages)]
        want = [s.report() for s in JAXP.tokenobs.default_llm_signals(pages)]
        assert got == want


# ---------------------------------------------------------------------------
# no card
# ---------------------------------------------------------------------------

def test_element_without_cpu_request_raises(monkeypatch):
    """No card and no ``device:cpu``: start() raises ``DeviceError`` (the
    pipeline reports it) instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = PORT.parse_launch(
        f"appsrc name=src caps={REQ_CAPS} ! tensor_llm name=llm "
        f"custom={CUSTOM.replace(',device:cpu', '')} ! tensor_sink")
    with pytest.raises(Exception, match="no CUDA device") as ei:
        p.play()
    p.stop()
    assert isinstance(ei.value.__cause__, DeviceError)
    assert getattr(p.get("llm"), "engine", None) is None
