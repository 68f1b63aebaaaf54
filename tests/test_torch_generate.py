"""Token serving on the port's CPU engine (mmlspark_tpu_torch/serve/generate.py
and the generator surfaces of serve/server.py).

The engine's correctness anchor, as in the JAX package's
``tests/test_generate.py``: a request's token stream is **bit-identical**
whether it decodes alone (``oneshot``: fresh buffers, synchronous) or packed
into the continuously batched slots with churning neighbours. The logits
along a greedy path are held against the JAX model's pure decode on the
same token history and weights (tolerance 1e-5, the model test's: float32
on both sides, other summation orders) — the pure functions, not the JAX
engine, whose batched tests are flaky under this JAX version. Around it:
typed admission errors, the slot ledger, shutdown, the shape budget and
the server and client surfaces.
"""

import threading
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models.convert import sequence_state_dict_from_flax
from mmlspark_tpu_torch.models.sequence import TransformerTagger
from mmlspark_tpu_torch.ops.attention import decode_attention
from mmlspark_tpu_torch.serve.batcher import THREAD_PREFIX
from mmlspark_tpu_torch.serve.config import GenerateConfig
from mmlspark_tpu_torch.serve.errors import (
    BadRequest, ModelLoadError, ModelNotFound, Overloaded, ServerClosed,
)
from mmlspark_tpu_torch.serve.generate import (
    GenerateBatcher, GenerateRequest, SlotTable, TokenStream,
)
from mmlspark_tpu_torch.serve.server import Client, ModelServer

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.models.sequence import TransformerTagger as JaxTagger  # noqa: E402

VOCAB = 97
KW = dict(vocab_size=VOCAB, embed_dim=32, num_heads=4, num_layers=2,
          mlp_dim=64, num_tags=VOCAB, max_len=64, causal=True)
ATOL = 1e-5


def small_cfg(**kw):
    base = dict(slots=4, t_max=32, prefill_buckets=(4, 8), prefill_rows=2,
                max_new_tokens=6, max_queue=32)
    base.update(kw)
    return GenerateConfig(**base)


def prompts(n, seed=0, lo=2, hi=8):
    r = np.random.default_rng(seed)
    return [[int(t) for t in r.integers(1, VOCAB, int(r.integers(lo, hi + 1)))]
            for _ in range(n)]


@pytest.fixture(scope="module")
def lm():
    jm = JaxTagger(**KW)
    params = jm.init(jax.random.PRNGKey(0),
                     np.zeros((1, 8), np.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, sequence_state_dict_from_flax(params)


def port_model(state_dict, **kw):
    model = TransformerTagger(device="cpu", **{**KW, **kw})
    model.load_state_dict(state_dict)
    return model


@pytest.fixture(scope="module")
def engine(lm):
    eng = GenerateBatcher("lm", port_model(lm[2]), config=small_cfg(),
                          device="cpu")
    yield eng
    eng.close()


def slow_decode_attention(hold_s=0.004):
    """decode_attention with a host hold — makes slot and queue occupancy
    deterministic for the admission tests."""
    def fn(q, k, v, keep):
        time.sleep(hold_s)
        return decode_attention(q, k, v, kv_mask=keep)
    return fn


# ---- the bit-identity anchor ----


def test_batched_streams_equal_oneshot(engine):
    ps = prompts(8, seed=1)
    refs = [engine.oneshot(p, max_new_tokens=5) for p in ps]
    streams = [engine.submit(p, max_new_tokens=5) for p in ps]
    got = [s.result(timeout=60) for s in streams]
    assert got == refs
    assert all(len(t) == 5 for t in got)


def test_greedy_path_logits_match_the_jax_pure_decode(lm, engine):
    """Prefill then decode one prompt in slot 1 of 4 (slot 0 inactive)
    through the port's model and the JAX model's pure functions, feeding
    both the port's greedy tokens: every step's logits agree, and the
    tokens are the engine's own oneshot stream."""
    jm, params, state_dict = lm
    model = port_model(state_dict)
    prompt = prompts(1, seed=7, lo=5, hi=5)[0]
    n, steps, t_max, S = len(prompt), 6, 32, 4
    toks = np.zeros((1, 8), np.int32)
    toks[0, :n] = prompt
    am = np.zeros((1, 8), bool)
    am[0, :n] = True
    jl, (pk, pv) = jm.apply({"params": params}, toks, mask=am,
                            return_cache=True)
    with torch.no_grad():
        tl, (tk, tv) = model(torch.from_numpy(toks),
                             mask=torch.from_numpy(am), return_cache=True)
    np.testing.assert_allclose(tl[0, n - 1].numpy(), np.asarray(jl)[0, n - 1],
                               rtol=0, atol=ATOL)
    shape = (S, KW["num_layers"], KW["num_heads"], t_max, 8)
    jk = np.zeros(shape, np.float32)
    jv = np.zeros(shape, np.float32)
    jk[1, :, :, :8] = np.asarray(pk)[0]
    jv[1, :, :, :8] = np.asarray(pv)[0]
    jcache = (jnp.asarray(jk), jnp.asarray(jv))
    ck, cv = torch.zeros(shape), torch.zeros(shape)
    ck[1, :, :, :8] = tk[0]
    cv[1, :, :, :8] = tv[0]
    active = np.array([False, True, False, False])
    path = [int(tl[0, n - 1].argmax())]
    for step in range(steps - 1):
        pos = np.array([0, n + step, 0, 0], np.int32)
        tok = np.zeros((S, 1), np.int32)
        tok[1, 0] = path[-1]
        jlog, jcache = jm.apply({"params": params}, tok, cache=jcache,
                                positions=jnp.asarray(pos),
                                update_mask=jnp.asarray(active))
        with torch.no_grad():
            tlog, _ = model.decode_step(torch.from_numpy(tok), (ck, cv),
                                        torch.from_numpy(pos),
                                        update_mask=torch.from_numpy(active))
        np.testing.assert_allclose(tlog[1].numpy(), np.asarray(jlog)[1],
                                   rtol=0, atol=ATOL)
        path.append(int(tlog[1].argmax()))
    assert engine.oneshot(prompt, max_new_tokens=steps) == path


def test_eos_token_stops_stream_and_oneshot_alike(lm):
    probe = GenerateBatcher("probe", port_model(lm[2]), config=small_cfg(),
                            device="cpu")
    try:
        p = free_run = None
        for seed in range(4, 40):
            cand = prompts(1, seed=seed)[0]
            run = probe.oneshot(cand, max_new_tokens=6)
            if any(t != run[0] for t in run[1:]):
                p, free_run = cand, run
                break
    finally:
        probe.close()
    assert p is not None, "no probe prompt produced 2 distinct tokens"
    eos = next(t for t in free_run[1:] if t != free_run[0])
    stop = free_run.index(eos)
    eng = GenerateBatcher("eos", port_model(lm[2]),
                          config=small_cfg(eos_token=eos), device="cpu")
    try:
        ref = eng.oneshot(p, max_new_tokens=6)
        got = eng.submit(p, max_new_tokens=6).result(timeout=60)
    finally:
        eng.close()
    assert got == ref == free_run[:stop + 1]


def test_shape_budget_holds_after_mixed_traffic(engine):
    ps = prompts(6, seed=3, lo=2, hi=4) + prompts(6, seed=4, lo=5, hi=8)
    streams = [engine.submit(p, max_new_tokens=3) for p in ps]
    for s in streams:
        s.result(timeout=60)
    budget = len(engine.config.prefill_buckets) + 1
    assert engine.program_shapes() == budget


def test_stats_count_tokens_steps_and_latencies(lm):
    eng = GenerateBatcher("stats", port_model(lm[2]), config=small_cfg(),
                          device="cpu")
    try:
        streams = [eng.submit(p, max_new_tokens=4)
                   for p in prompts(5, seed=8)]
        for s in streams:
            s.result(timeout=60)
    finally:
        eng.close()
    snap = eng.stats.snapshot()
    assert snap["generate_requests"] == 5 and snap["completed"] == 5
    assert snap["tokens_out"] == 20
    assert snap["ttft_ms"]["n"] == 5 and snap["itl_ms"]["n"] == 15
    assert snap["decode_steps"] >= 3
    assert 0 < snap["slot_occupancy_mean"] <= 1
    assert snap["failed"] == 0


# ---- admission validation (typed, before any device work) ----


class TestValidation:
    def test_empty_prompt_rejected(self, engine):
        with pytest.raises(BadRequest, match="empty prompt"):
            engine.submit([])

    def test_nonpositive_budget_rejected(self, engine):
        with pytest.raises(BadRequest, match="max_new_tokens"):
            engine.submit([1, 2], max_new_tokens=0)

    def test_prompt_beyond_ladder_rejected(self, engine):
        with pytest.raises(BadRequest, match="largest prefill bucket"):
            engine.submit(list(range(1, 10)))  # 9 > bucket 8

    def test_cache_horizon_overflow_rejected(self, engine):
        with pytest.raises(BadRequest, match="cache horizon"):
            engine.submit([1] * 8, max_new_tokens=25)  # 8 + 25 > 32

    def test_token_out_of_vocabulary_rejected(self, engine):
        with pytest.raises(BadRequest, match="token ids"):
            engine.submit([1, VOCAB])

    def test_non_causal_model_rejected_at_construction(self, lm):
        acausal = port_model(lm[2], causal=False)
        with pytest.raises(BadRequest, match="causal"):
            GenerateBatcher("acausal", acausal, device="cpu")

    def test_horizon_beyond_model_positions_rejected(self, lm):
        with pytest.raises(BadRequest, match="positions"):
            GenerateBatcher("long", port_model(lm[2]),
                            config=small_cfg(t_max=65), device="cpu")

    def test_config_validation_is_load_fast(self):
        with pytest.raises(ValueError, match="t_max"):
            small_cfg(t_max=8)  # cannot hold bucket 8 + one token
        with pytest.raises(ValueError, match="slots"):
            small_cfg(slots=0)
        with pytest.raises(ValueError, match="prefill_rows"):
            small_cfg(prefill_rows=0)
        with pytest.raises(ModelLoadError):
            small_cfg(prefill_buckets=(8, 4))  # not ascending

    def test_overload_backpressure_then_abort_fails_typed(self, lm):
        # one slot + one queue seat, decode slowed: the third admission
        # MUST bounce Overloaded; drain=False then fails the outstanding
        # streams with ServerClosed instead of stranding them
        eng = GenerateBatcher(
            "tiny", port_model(lm[2]),
            config=small_cfg(slots=1, max_queue=1, retry_after_s=2.5),
            decode_attention_fn=slow_decode_attention(), device="cpu")
        streams = []
        try:
            with pytest.raises(Overloaded) as info:
                for _ in range(200):
                    streams.append(eng.submit([1, 2], max_new_tokens=20))
                pytest.fail("queue never filled")  # pragma: no cover
            assert info.value.retry_after_s == 2.5
        finally:
            eng.close(drain=False)
        assert streams
        failed = 0
        for stream in streams:
            try:
                stream.result(timeout=10)
            except ServerClosed:
                failed += 1
        assert failed >= 1, "abort close let every slow stream finish"
        with pytest.raises(ServerClosed) as info:
            eng.submit([1, 2])
        assert info.value.retry_after_s == 2.5


# ---- the slot ledger ----


class TestSlotTable:
    def mk_req(self):
        return GenerateRequest([1], 1, TokenStream("m"))

    def test_assign_release_and_free_accounting(self):
        st = SlotTable(2)
        a, b = self.mk_req(), self.mk_req()
        assert st.assign(a) == 0 and st.assign(b) == 1
        assert st.free == 0 and st.assign(self.mk_req()) is None
        st.release(a)
        assert st.free == 1 and st.owner(0) is None
        assert st.owner(1) is b
        c = self.mk_req()
        assert st.assign(c) == 0 and c.slot == 0

    def test_double_assignment_raises(self):
        st = SlotTable(2)
        req = self.mk_req()
        st.assign(req)
        with pytest.raises(RuntimeError, match="already owns"):
            st.assign(req)

    def test_release_by_non_owner_raises(self):
        st = SlotTable(1)
        req = self.mk_req()
        st.assign(req)
        st.release(req)
        with pytest.raises(RuntimeError, match="non-owner"):
            st.release(req)


# ---- stream + lifecycle semantics ----


class TestStreamAndLifecycle:
    def test_iteration_matches_result_and_terminates(self):
        ts = TokenStream("m")
        for t in (3, 1, 4):
            ts._push(t)
        ts._finish()
        assert list(ts) == [3, 1, 4] == ts.result() == ts.tokens
        assert ts.done

    def test_failed_stream_raises_from_both_surfaces(self):
        ts = TokenStream("m")
        ts._push(7)
        ts._fail(Overloaded("m", 1, 1))
        with pytest.raises(Overloaded):
            list(ts)
        with pytest.raises(Overloaded):
            ts.result()

    def test_result_timeout_is_typed(self):
        ts = TokenStream("m")
        with pytest.raises(TimeoutError, match="not terminal"):
            ts.result(timeout=0.05)

    def test_close_drains_everything_and_joins_the_thread(self, lm):
        eng = GenerateBatcher("drain", port_model(lm[2]),
                              config=small_cfg(), device="cpu")
        ps = prompts(6, seed=5)
        refs = [eng.oneshot(p) for p in ps]
        streams = [eng.submit(p) for p in ps]
        eng.close(drain=True)
        assert [s.result(timeout=1) for s in streams] == refs
        with pytest.raises(ServerClosed):
            eng.submit([1, 2])
        eng.close()  # idempotent
        assert not eng._thread.is_alive()
        leaked = [t.name for t in threading.enumerate()
                  if t.name.startswith(f"{THREAD_PREFIX}[drain]")]
        assert leaked == []


# ---- the server / Client surfaces ----


@pytest.fixture(scope="module")
def generate_server(lm):
    server = ModelServer()
    server.add_generator("lm", port_model(lm[2]), config=small_cfg(),
                         device="cpu")
    yield server
    server.close()


class TestServerSurfaces:
    def test_client_generate_blocking_and_streaming(self, generate_server):
        client = Client(generate_server)
        p = prompts(1, seed=6)[0]
        ref = generate_server.generate_oneshot("lm", p, max_new_tokens=5)
        assert client.generate("lm", p, max_new_tokens=5) == ref
        stream = client.generate("lm", p, max_new_tokens=5, stream=True)
        assert list(stream) == ref

    def test_generators_listed_and_unknown_name_typed(self, generate_server):
        assert generate_server.generators() == ["lm"]
        assert generate_server.models() == []
        with pytest.raises(ModelNotFound):
            generate_server.generate("nope", [1, 2])
        snap = generate_server.snapshot()["lm"]
        assert "ttft_ms" in snap and snap["queued"] == 0

    def test_one_namespace_for_models_and_generators(self, lm):
        from mmlspark_tpu_torch.models.zoo import get_model
        with ModelServer() as server:
            server.add_generator("lm", port_model(lm[2]), config=small_cfg(),
                                 device="cpu")
            with pytest.raises(ModelLoadError, match="one name"):
                server.add_model("lm", get_model("ViT_Tiny", device="cpu"),
                                 device="cpu")
            server.add_model("vit", get_model("ViT_Tiny", device="cpu"),
                             device="cpu")
            with pytest.raises(ModelLoadError, match="one name"):
                server.add_generator("vit", port_model(lm[2]),
                                     config=small_cfg(), device="cpu")
            assert server.generators() == ["lm"]
            assert server.models() == ["vit"]

    def test_state_dict_is_loaded_and_swap_drains_the_old_engine(self, lm):
        with ModelServer() as server:
            blank = TransformerTagger(device="cpu", **KW)
            server.add_generator("lm", blank, lm[2], config=small_cfg(),
                                 device="cpu")
            p = prompts(1, seed=9)[0]
            ref = port_model(lm[2])
            eng = GenerateBatcher("ref", ref, config=small_cfg(),
                                  device="cpu")
            try:
                want = eng.oneshot(p)
            finally:
                eng.close()
            assert server.generate_oneshot("lm", p) == want
            old = server._generator("lm")
            stream = server.generate("lm", p)
            server.add_generator("lm", port_model(lm[2]),
                                 config=small_cfg(), device="cpu")
            assert stream.result(timeout=10) == want
            assert not old._thread.is_alive()

    def test_close_joins_generators_and_rejects_new_ones(self, lm):
        server = ModelServer()
        server.add_generator("g", port_model(lm[2]), config=small_cfg(),
                             device="cpu")
        stream = server.generate("g", [1, 2, 3])
        server.close()
        assert len(stream.result(timeout=10)) == small_cfg().max_new_tokens
        leaked = [t.name for t in threading.enumerate()
                  if t.name.startswith(f"{THREAD_PREFIX}[g]")]
        assert leaked == []
        with pytest.raises(ServerClosed):
            server.add_generator("h", port_model(lm[2]), config=small_cfg(),
                                 device="cpu")
