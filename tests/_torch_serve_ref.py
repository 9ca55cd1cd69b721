"""Shared set-up of the port's serving tests: the reference's traces, its
token streams with their top-2 logit gaps, and port batchers on the same
weights.

The weights are the reduced yi-6b of the reference's scheduler tests
(``with_(n_layers=2, vocab=64)``, ``init_params(PRNGKey(seed))``), carried
into the port by ``decoder_lm_from_arrays``. The reference tokens are the
JAX fifo batcher's; the gaps come from a greedy loop over the JAX
``decode_step`` from position 0, one request at a time.

Token streams are compared up to the first step whose reference gap is
below :data:`MIN_GAP`. Both packages round to bf16 at the same places but
sum in other orders, and a continuous slot decodes at another absolute
position than fifo, which moves a gap by up to about 0.02 on this model
(RoPE rotates by the absolute angle). The traces below were chosen by the
reference to clear ~0.08 at every step, but two do not: ``p2``'s second
token has a reference gap of 0.0117 (float) and 0.0146 (quantized), and
the port's continuous path flips it at some admission offsets; and
``s0`` of the shared trace opens with a gap of 0.0018. Every other step
clears 0.02, so those are the only tokens left out: 31 of the parity
trace's 32 and 14 of the shared trace's 20 (``assert_streams`` returns
the count).

Speculative streams are held against the reference's speculative streams
in the same mode, with the gaps of a JAX loop teacher-forced along them.
The reference's own speculative trace is not tie-free either: ``g2``'s
fourth token is a 0.0009 tie (23 over 22) under the loop from position
0, which the reference's speculative lanes follow while its plain
continuous path, at another absolute position, flips it.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MIN_GAP = 0.02

# the reference's gap-robust trace of tests/test_scheduler.py
PARITY_TRACE = [
    ("p0", [63, 51, 50], 7),
    ("p1", [33, 17, 32], 5),
    ("p2", [63, 1], 2),
    ("p3", [30, 52], 4),
    ("p4", [39, 53], 7),
    ("p5", [55, 44, 23], 7),
]

# tests/test_paged_serve.py: two waves sharing an 18-token system prompt
SYSTEM = [7, 3, 11, 2, 9, 40, 41, 5, 8, 60, 13, 21, 34, 55, 1, 6, 17, 28]
SHARED_TRACE = [
    [("s0", SYSTEM + [63, 51], 6), ("s1", SYSTEM + [33, 17, 9], 5)],
    [("s2", SYSTEM + [12], 4), ("s3", SYSTEM + [44, 2], 5)],
]


# tests/test_speculative.py: six requests through one 32 x 2 bucket
SPEC_TRACE = [
    (f"g{i}", [2 + (7 * i + 13 * j) % 50 for j in range(2 + i % 3)],
     4 + i % 4)
    for i in range(6)
]
SPEC_BUCKET = (32, 2)          # (max_len, batch)


def waves(trace) -> List[List[Tuple[str, List[int], int]]]:
    return trace if isinstance(trace[0], list) else [trace]


def jax_cfg():
    from repro.configs import reduced_config

    return reduced_config("yi_6b").with_(n_layers=2, vocab=64)


def torch_cfg():
    from repro_torch.configs import reduced_config

    return reduced_config("yi_6b").with_(n_layers=2, vocab=64)


@functools.lru_cache(maxsize=None)
def jax_params(seed: int):
    from repro.dist.sharding import init_params
    from repro.models import build_model

    return init_params(jax.random.PRNGKey(seed),
                       build_model(jax_cfg()).param_specs())


@functools.lru_cache(maxsize=None)
def arrays(seed: int):
    """The reference's parameter tree as numpy arrays (bf16 kept)."""
    return jax.tree.map(np.asarray, jax_params(seed))


def _jax_gaps(seed: int, quantized: bool, trace,
              forced: Optional[Dict[str, List[int]]] = None
              ) -> Dict[str, List[float]]:
    """Per request, the top-2 logit gap at every generated step of a JAX
    greedy loop over ``decode_step`` from position 0, one request at a
    time; with ``forced`` the loop follows those streams instead of its
    own argmax."""
    from repro.models import build_model
    from repro.plan import MeshSpec, build_plan

    plan = build_plan(jax_cfg(), None, mesh_spec=MeshSpec.debug(1, 1),
                      quantized=quantized)
    gaps: Dict[str, List[float]] = {}
    with plan.activate():
        sparams = plan.shard_params(jax_params(seed))
        step = jax.jit(build_model(plan.cfg).decode_step)
        for wave in waves(trace):
            for rid, prompt, n in wave:
                state = plan.fresh_decode_state(1, 64)
                tok, g = None, []
                for i in range(len(prompt) + n - 1):
                    t_in = prompt[i] if i < len(prompt) else tok
                    logits, state = step(sparams, state,
                                         jnp.asarray([t_in], jnp.int32),
                                         jnp.int32(i))
                    lg = np.sort(np.asarray(logits[0], np.float64))
                    tok = int(np.argmax(np.asarray(logits[0])))
                    if i >= len(prompt) - 1:
                        g.append(float(lg[-1] - lg[-2]))
                        if forced is not None:
                            tok = forced[rid][len(g) - 1]
                gaps[rid] = g
    return gaps


@functools.lru_cache(maxsize=None)
def jax_reference(seed: int, quantized: bool, trace_name: str):
    """``(tokens, gaps)`` of the reference on a trace: the JAX fifo
    batcher's streams (one wave after another) and, per request, the top-2
    logit gap at every generated step of a JAX greedy loop from
    position 0."""
    from repro.launch.mesh import make_debug_mesh
    from repro.serve import DecodeRequest, ServeBatcher

    trace = {"parity": PARITY_TRACE, "shared": SHARED_TRACE}[trace_name]
    cfg, params = jax_cfg(), jax_params(seed)
    tokens: Dict[str, List[int]] = {}
    mesh = make_debug_mesh(1, 1)
    with mesh:
        b = ServeBatcher(cfg, mesh, quantized=quantized).load_params(params)
        for wave in waves(trace):
            for rid, p, n in wave:
                b.submit(DecodeRequest(rid, p, max_new_tokens=n))
            tokens.update({r: v.tokens for r, v in b.run().items()})
    return tokens, _jax_gaps(seed, quantized, trace)


@functools.lru_cache(maxsize=None)
def jax_spec_reference(seed: int, quantized: bool, k: int, paged: bool,
                       draft: Optional[str], trace: Tuple):
    """``(tokens, spec stats, gaps)`` of the reference's speculative
    continuous batcher on ``trace`` (a tuple of ``(id, prompt tuple,
    n)``) through the 32 x 2 bucket, k = ``steps_per_dispatch``, paged
    with 4-token pages; the gaps follow the reference's own streams."""
    from repro.launch.mesh import make_debug_mesh
    from repro.serve import Bucket, BucketPolicy, DecodeRequest, ServeBatcher

    max_len, batch = SPEC_BUCKET
    mesh = make_debug_mesh(1, 1)
    with mesh:
        b = ServeBatcher(jax_cfg(), mesh, quantized=quantized,
                         policy=BucketPolicy([Bucket(max_len, batch)]),
                         schedule="continuous", steps_per_dispatch=k,
                         paged=4 if paged else None, speculative=k,
                         draft=draft).load_params(jax_params(seed))
        for rid, p, n in trace:
            b.submit(DecodeRequest(rid, list(p), max_new_tokens=n))
        tokens = {r: v.tokens for r, v in b.run().items()}
    return (tokens, b.scheduler.stats()["spec"],
            _jax_gaps(seed, quantized, list(trace), forced=tokens))


def assert_streams(got: Dict[str, Sequence[int]], want: Dict[str, List[int]],
                   gaps: Dict[str, List[float]], ids, context=()) -> int:
    """Each stream of ``ids`` has the reference's length and equals its
    reference stream up to the first step whose gap is below
    :data:`MIN_GAP`; returns the number of tokens compared."""
    compared = 0
    for rid in ids:
        assert len(got[rid]) == len(want[rid]), (context, rid)
        n = next((i for i, g in enumerate(gaps[rid]) if g < MIN_GAP),
                 len(want[rid]))
        assert list(got[rid][:n]) == want[rid][:n], (context, rid, n)
        compared += n
    return compared


def port_batcher(seed: int, quantized: bool = False, **kw):
    """A port ServeBatcher on the CPU holding the reference's weights."""
    from repro_torch.plan import build_plan

    plan = build_plan(torch_cfg(), None, quantized=quantized, device="cpu")
    return plan.make_batcher(**kw).load_params(arrays(seed))


def serve(batcher, trace) -> Dict[str, List[int]]:
    """Submit every wave of ``trace`` and run it; the streams by id."""
    from repro_torch.serve import DecodeRequest

    out: Dict[str, List[int]] = {}
    for wave in waves(trace):
        for rid, p, n in wave:
            batcher.submit(DecodeRequest(rid, p, max_new_tokens=n))
        out.update({r: v.tokens for r, v in batcher.run().items()})
    return out


# ---------------------------------------------------------------------------
# the other families' own streams (hybrid, MoE, RWKV, qwen): the reference's
# batcher in one mode on a reduced config, the gaps of a JAX greedy loop
# teacher-forced along its streams, and the port's batcher on the same
# weights
# ---------------------------------------------------------------------------

FAMILY_BUCKET = (64, 2)        # (max_len, batch)
FAMILY_PAGED = (64, 16)        # tests/test_paged_serve.py
TRACES = {"parity": PARITY_TRACE, "shared": SHARED_TRACE}


# Families whose reference initialisers leave leaves at zero that the tests
# must see nonzero: the encoder-decoder's MLP and LayerNorm biases and the
# vision LM's cross-attention gates (at zero, tanh(gate) = 0 and a cross
# block adds nothing from its attention). ``family_params`` draws them.
DRAWN_FAMILIES = ("encdec", "vlm")


def draw_zero_leaves(params, seed: int):
    """``params`` with every bias (``b``, ``bias``) drawn from N(0, 0.5^2)
    and every ``gate`` uniform in [0.5, 1], from numpy seed ``seed + 23``,
    in each leaf's dtype."""
    rng = np.random.default_rng(seed + 23)

    def draw(path, leaf):
        name = path[-1].key
        if name == "gate":
            new = rng.uniform(0.5, 1.0, leaf.shape)
        elif name in ("b", "bias"):
            new = rng.standard_normal(leaf.shape) * 0.5
        else:
            return leaf
        return jnp.asarray(new, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, params)


@functools.lru_cache(maxsize=None)
def family_params(arch: str, seed: int):
    """The reference's parameters of ``arch``'s reduced config (with the
    zero leaves of :data:`DRAWN_FAMILIES` drawn at random)."""
    from repro.configs import reduced_config
    from repro.dist.sharding import init_params
    from repro.models import build_model

    cfg = reduced_config(arch)
    params = init_params(jax.random.PRNGKey(seed),
                         build_model(cfg).param_specs())
    if cfg.family in DRAWN_FAMILIES:
        params = draw_zero_leaves(params, seed)
    return params


@functools.lru_cache(maxsize=None)
def family_arrays(arch: str, seed: int, fp32: bool = False):
    """The reference's tree as numpy arrays (bf16 kept, or fp32)."""
    dtype = np.float32 if fp32 else None
    return jax.tree.map(lambda a: np.asarray(a, dtype), family_params(arch,
                                                                      seed))


@functools.lru_cache(maxsize=None)
def _family_batcher_streams(arch, seed, quantized, schedule, k, paged, spec,
                            trace_name):
    """The reference batcher's streams on a trace, one wave after another,
    with its plan and sharded (calibrated) parameters."""
    from repro.configs import reduced_config
    from repro.launch.mesh import make_debug_mesh
    from repro.serve import Bucket, BucketPolicy, DecodeRequest, ServeBatcher

    max_len, batch = FAMILY_BUCKET
    kw = {}
    if schedule == "continuous":
        kw = dict(steps_per_dispatch=k,
                  paged=FAMILY_PAGED if paged else None,
                  speculative=k if spec else 0)
    mesh = make_debug_mesh(1, 1)
    tokens: Dict[str, List[int]] = {}
    with mesh:
        b = ServeBatcher(reduced_config(arch), mesh, quantized=quantized,
                         policy=BucketPolicy([Bucket(max_len, batch)]),
                         schedule=schedule, **kw
                         ).load_params(family_params(arch, seed))
        for wave in waves(TRACES[trace_name]):
            for rid, p, n in wave:
                b.submit(DecodeRequest(rid, p, max_new_tokens=n))
            tokens.update({r: v.tokens for r, v in b.run().items()})
    return tokens, b.plan, b.params


@functools.lru_cache(maxsize=None)
def _family_step(cfg):
    """The reference's jitted ``decode_step`` for a (calibrated) config."""
    from repro.models import build_model

    return jax.jit(build_model(cfg).decode_step)


def family_reference(arch: str, seed: int, quantized: bool, schedule: str,
                     k: int, paged: bool, trace_name: str, *,
                     skipped: int = 0, spec: bool = False):
    """``(tokens, gaps, loop)``: the reference batcher's streams on a trace
    in one mode, and per request the top-2 logit gaps and argmax tokens of
    a JAX greedy loop from position 0 teacher-forced along them.

    ``skipped`` N > 0 reproduces the prefix cache on waves after the
    first: the recurrent leaves (every leaf but the KV cache) are zeroed
    after N prompt tokens, as a follower that maps N tokens of published
    pages starts from a fresh recurrent state (the KV rows of those tokens
    are the same either way)."""
    tokens, plan, sparams = _family_batcher_streams(
        arch, seed, quantized, schedule, k, paged, spec, trace_name)
    step = _family_step(plan.cfg)
    gaps: Dict[str, List[float]] = {}
    loop: Dict[str, List[int]] = {}
    with plan.activate():
        for w, wave in enumerate(waves(TRACES[trace_name])):
            for rid, prompt, n in wave:
                state = plan.fresh_decode_state(1, FAMILY_BUCKET[0])
                g, top = [], []
                for i in range(len(prompt) + n - 1):
                    if w and skipped and i == skipped:
                        state = {name: (leaf if name in ("cache_k", "cache_v")
                                        else jnp.zeros_like(leaf))
                                 for name, leaf in state.items()}
                    t_in = (prompt[i] if i < len(prompt)
                            else tokens[rid][i - len(prompt)])
                    logits, state = step(sparams, state,
                                         jnp.asarray([t_in], jnp.int32),
                                         jnp.int32(i))
                    if i >= len(prompt) - 1:
                        lg = np.asarray(logits[0], np.float64)
                        top.append(int(np.argmax(lg)))
                        lg = np.sort(lg)
                        g.append(float(lg[-1] - lg[-2]))
                gaps[rid], loop[rid] = g, top
    return tokens, gaps, loop


def family_port_streams(arch: str, seed: int, quantized: bool,
                        schedule: str, k: int, paged: bool, trace, *,
                        spec: bool = False):
    """``(batcher, tokens)``: the port's batcher in one mode on the
    reference's weights of ``arch``'s reduced config, over every wave of
    ``trace``."""
    from repro_torch.plan import build_plan
    from repro_torch.serve import Bucket, BucketPolicy

    plan = build_plan(arch, None, debug=True, quantized=quantized,
                      device="cpu")
    kw = {}
    if schedule == "continuous":
        kw = dict(steps_per_dispatch=k,
                  paged=FAMILY_PAGED if paged else None,
                  speculative=k if spec else 0)
    b = plan.make_batcher(policy=BucketPolicy([Bucket(*FAMILY_BUCKET)]),
                          schedule=schedule, **kw
                          ).load_params(family_arrays(arch, seed))
    return b, serve(b, trace)


def assert_gap_streams(got: Dict[str, Sequence[int]],
                       want: Dict[str, List[int]],
                       gaps: Dict[str, List[float]], min_gap: float,
                       context=()) -> int:
    """Each stream has the reference's length and equals it up to the
    first step whose reference gap is below ``min_gap``; returns the
    number of tokens compared."""
    compared = 0
    for rid in want:
        assert len(got[rid]) == len(want[rid]), (context, rid)
        n = next((i for i, g in enumerate(gaps[rid]) if g < min_gap),
                 len(want[rid]))
        assert list(got[rid][:n]) == want[rid][:n], (context, rid, n)
        compared += n
    return compared
