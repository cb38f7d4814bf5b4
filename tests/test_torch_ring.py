"""Ring attention, Ulysses and the zigzag layout of the port against the
JAX package.

One 4-process gloo gang on the CPU, spawned once for the file by a
module-scoped fixture (the pattern of ``tests/test_torch_gang.py``): each
rank runs this file as a script (``worker``), answers every case below
and writes what it computed to ``rank<r>.npz`` / ``rank<r>.json``; the
JAX references run meanwhile in three more processes (``jax_worker``,
the file run as ``... jax <dir> <cases>``), on four of the reference's
virtual CPU devices each. Every join has a timeout.

- ``make_ring_attention`` against the reference's, forward and every
  input gradient (the vjp of one seeded cotangent), fp32: non-causal,
  causal contiguous, causal zigzag (permuted by the wrapper, and already
  permuted, ``data_layout="zigzag"``), windows W ∈ {1, L, 2L+3} (hop
  pruning: 1, 2 and all 4 of the 4 hops; at W = 1, dq and dk are
  identically zero and held at dv's scale), packed segments on the contiguous
  and the zigzag layouts, window + segments, a ``data=2 × context=2``
  mesh (rows and sequence split), and a non-power-of-two local length
  (local 12, half-chunk 6; the reference's
  ``test_ring_attention_nonpow2_chunks``). The output within 1e-5 of its
  largest magnitude, each gradient within 1e-4 of its own.
- ``make_ulysses_attention`` against the reference's, causal and not,
  forward and gradients; heads not divisible by the context axis are
  refused.
- Windowed zigzag raises, in ``ring_attention`` and in the wrapper.
- ``zigzag_indices``, ``zigzag_batch`` and the loader's zigzag emission
  (the synthetic stream and a ``TokenDataset`` on a temporary shard)
  element for element against the reference's.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
JOIN_S = 120

#: name → (B, S, H, D, mesh (data, context), make_ring_attention kwargs,
#: segments). S 32 over context 4: local length L = 8.
RING_CASES = {
    "noncausal": (2, 32, 4, 16, (1, 4), dict(causal=False), None),
    "contiguous": (2, 32, 4, 16, (1, 4), dict(causal=True, zigzag=False),
                   None),
    "zigzag": (2, 32, 4, 16, (1, 4), dict(causal=True), None),
    "zigzag-native": (2, 32, 4, 16, (1, 4),
                      dict(causal=True, data_layout="zigzag"), None),
    "window1": (2, 32, 4, 16, (1, 4), dict(causal=True, window=1), None),
    "window8": (2, 32, 4, 16, (1, 4), dict(causal=True, window=8), None),
    "window19": (2, 32, 4, 16, (1, 4), dict(causal=True, window=19), None),
    "segments-contiguous": (2, 32, 4, 16, (1, 4),
                            dict(causal=True, zigzag=False), (10, 23)),
    "segments-zigzag": (2, 32, 4, 16, (1, 4), dict(causal=True), (10, 23)),
    "window11-segments": (2, 32, 4, 16, (1, 4), dict(causal=True, window=11),
                          (10, 23)),
    "data2-context2": (4, 32, 4, 16, (2, 2), dict(causal=True), (5, 20)),
    "nonpow2": (2, 48, 2, 16, (1, 4), dict(causal=True), None),
}
#: name → (B, S, H, D, causal)
ULYSSES_CASES = {
    "ulysses-causal": (2, 32, 8, 16, True),
    "ulysses-full": (2, 32, 8, 16, False),
}


def _segments(b, s, boundaries):
    ids = np.zeros((b, s), np.int32)
    pos = 0
    for seg, nxt in enumerate(list(boundaries) + [s], 1):
        ids[:, pos:nxt] = seg
        pos = nxt
    return ids


def _inputs():
    """Every case's q, k, v, cotangent (and segment ids) from one seed;
    ``zigzag-native`` takes ``zigzag``'s, already in zigzag order."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (b, s, h, d, *rest) in {**RING_CASES, **ULYSSES_CASES}.items():
        for x in ("q", "k", "v", "cot"):
            out[f"{name}/{x}"] = rng.standard_normal((b, s, h, d)).astype(
                np.float32)
        segs = rest[2] if name in RING_CASES else None
        if segs is not None:
            out[f"{name}/seg"] = _segments(b, s, segs)
    perm = _zigzag_perm()
    for x in ("q", "k", "v", "cot"):
        out[f"zigzag-native/{x}"] = out[f"zigzag/{x}"][:, perm]
    return out


def _zigzag_perm():
    from determined_tpu_torch.parallel.ring import zigzag_indices

    return zigzag_indices(RING_CASES["zigzag"][1], 4)


# ---------------------------------------------------------------------------
# The worker: one rank of the gang (``python tests/test_torch_ring.py``)
# ---------------------------------------------------------------------------
def worker(rank: int, store: str, out: str) -> None:
    import datetime

    import torch
    import torch.distributed as tdist

    from determined_tpu_torch.parallel import (
        MeshConfig,
        make_mesh,
        make_ring_attention,
        make_ulysses_attention,
        ring_attention,
    )

    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=JOIN_S))
    data = dict(np.load(os.path.join(out, "inputs.npz")))
    arrays, res = {}, {}
    meshes = {}

    def mesh_of(d, c):
        if (d, c) not in meshes:
            meshes[d, c] = make_mesh(MeshConfig(data=d, context=c),
                                     device="cpu")
        return meshes[d, c]

    def run(name, fn, with_seg):
        q, k, v = (torch.from_numpy(data[f"{name}/{x}"]).requires_grad_()
                   for x in ("q", "k", "v"))
        args = (q, k, v)
        if with_seg:
            args += (torch.from_numpy(data[f"{name}/seg"]),)
        o = fn(*args)
        o.backward(torch.from_numpy(data[f"{name}/cot"]))
        arrays[f"{name}/o"] = o.detach().numpy()
        for x, t in zip("qkv", (q, k, v)):
            arrays[f"{name}/d{x}"] = t.grad.numpy()

    for name, (*_, (d, c), kw, segs) in RING_CASES.items():
        run(name, make_ring_attention(mesh_of(d, c), **kw), segs is not None)
    for name, (*_, causal) in ULYSSES_CASES.items():
        run(name, make_ulysses_attention(mesh_of(1, 4), causal=causal), False)

    # the refusals
    mesh = mesh_of(1, 4)
    x = torch.zeros((1, 8, 6, 16))
    for key, call in (
        ("ulysses_heads", lambda: make_ulysses_attention(mesh)(x, x, x)),
        ("zigzag_window", lambda: ring_attention(
            x, x, x, group=mesh, layout="zigzag", window=4)),
        ("zigzag_window_wrapper", lambda: make_ring_attention(
            mesh, window=8, data_layout="zigzag")),
    ):
        try:
            call()
            res[key] = None
        except ValueError as e:
            res[key] = str(e)

    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# The fixture: the gang, and the JAX references meanwhile
# ---------------------------------------------------------------------------
def jax_worker(out: str, names) -> None:
    """The JAX references of `names` (``python tests/test_torch_ring.py
    jax <dir> <names...>``): each case's output and input gradients, in
    one jitted vjp, to ``jax-<first name>.npz``."""
    import jax
    import jax.numpy as jnp

    from determined_tpu.parallel import MeshConfig, make_mesh
    from determined_tpu.parallel.ring import make_ring_attention
    from determined_tpu.parallel.ulysses import make_ulysses_attention

    jax.config.update("jax_platforms", "cpu")
    data = dict(np.load(os.path.join(out, "inputs.npz")))
    arrays = {}
    for name in names:
        q, k, v, cot = (jnp.asarray(data[f"{name}/{x}"])
                        for x in ("q", "k", "v", "cot"))
        seg = None
        if name in RING_CASES:
            *_, (d, c), kw, segs = RING_CASES[name]
            mesh = make_mesh(MeshConfig(data=d, context=c),
                             jax.devices()[:WORLD])
            fn = make_ring_attention(mesh, **kw)
            if segs is not None:
                seg = jnp.asarray(data[f"{name}/seg"])
        else:
            mesh = make_mesh(MeshConfig(data=1, context=4),
                             jax.devices()[:WORLD])
            fn = make_ulysses_attention(mesh, causal=ULYSSES_CASES[name][-1])

        @jax.jit
        def both(q, k, v, cot, seg):
            call = ((lambda q, k, v: fn(q, k, v)) if seg is None
                    else (lambda q, k, v: fn(q, k, v, seg)))
            o, vjp = jax.vjp(call, q, k, v)
            return (o, *vjp(cot))

        for key, a in zip(("o", "dq", "dk", "dv"), both(q, k, v, cot, seg)):
            arrays[f"{name}/{key}"] = np.asarray(a)
    np.savez(os.path.join(out, f"jax-{names[0]}.npz"), **arrays)


#: the JAX references' processes: each compiles its share of the cases
#: (``zigzag-native``'s reference is ``zigzag``'s, permuted)
JAX_SHARES = (
    ("zigzag", "noncausal", "window1", "window8", "ulysses-full"),
    ("segments-zigzag", "contiguous", "window19", "segments-contiguous",
     "ulysses-causal"),
    ("nonpow2", "data2-context2", "window11-segments"),
)


def _spawn(tmp):
    """The gang's four ranks, then the JAX processes."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DTPU_", "JAX_", "XLA_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", TMPDIR=str(tmp))
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    procs = []
    argvs = [([str(rank), str(tmp / "store"), str(tmp)], env)
             for rank in range(WORLD)]
    argvs += [(["jax", str(tmp), *names], jenv) for names in JAX_SHARES]
    for i, (argv, e) in enumerate(argvs):
        log = open(tmp / f"proc{i}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, *argv], cwd=ROOT, env=e, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _join(procs, tmp):
    deadline = time.time() + JOIN_S
    failed = None
    try:
        while time.time() < deadline:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if all(c == 0 for c in codes):
                return
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
            log.close()
    logs = "\n".join(
        f"--- process {r} ---\n{(tmp / f'proc{r}.log').read_text()[-4000:]}"
        for r in range(len(procs)) if failed is None or r == failed)
    raise AssertionError(
        (f"process {failed} failed" if failed is not None
         else f"the processes did not finish in {JOIN_S} s") + "\n" + logs)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    np.savez(tmp / "inputs.npz", **_inputs())
    _join(_spawn(tmp), tmp)
    ref = {}
    for names in JAX_SHARES:
        for key, a in np.load(tmp / f"jax-{names[0]}.npz").items():
            name, what = key.split("/")
            ref.setdefault(name, {})[what] = a
    perm = _zigzag_perm()
    ref["zigzag-native"] = {k: a[:, perm] for k, a in ref["zigzag"].items()}
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as fh:
            ranks.append((json.load(fh), dict(np.load(tmp / f"rank{r}.npz"))))
    return {"ranks": ranks, "ref": ref}


def _hold(gang, name):
    want = gang["ref"][name]
    for r, (_, arrays) in enumerate(gang["ranks"]):
        for key, tol in (("o", 1e-5), ("dq", 1e-4), ("dk", 1e-4),
                         ("dv", 1e-4)):
            scale = float(np.abs(want[key]).max())
            if name == "window1" and key in ("dq", "dk"):
                # A window of 1: each query attends its own key alone, so
                # the softmax is 1 whatever the scores and dq, dk are
                # identically zero; both packages return rounding noise
                # there, held at the scale of the gradient that is not.
                scale = float(np.abs(want["dv"]).max())
            np.testing.assert_allclose(
                arrays[f"{name}/{key}"], want[key], rtol=0,
                atol=tol * scale, err_msg=f"{name} rank {r} {key}")


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_attention_matches_the_jax_ring(gang, name):
    _hold(gang, name)


@pytest.mark.parametrize("name", list(ULYSSES_CASES))
def test_ulysses_attention_matches_the_jax_ulysses(gang, name):
    _hold(gang, name)


def test_window_prunes_hops():
    """The three windows reach 1, 2 and all 4 of the 4 hops: the first
    two prune the ring, W = 2L+3 runs it whole."""
    L, R = 8, 4
    hops = [min(R, (w + L - 2) // L + 1) for w in (1, 8, 19)]
    assert hops == [1, 2, 4]


@pytest.mark.parametrize("key,match", [
    ("ulysses_heads", "heads \\(6\\) divisible by the context axis \\(4\\)"),
    ("zigzag_window", "contiguous' only"),
    ("zigzag_window_wrapper", "window needs the contiguous ring layout"),
])
def test_refusals(gang, key, match):
    import re

    for r, (res, _) in enumerate(gang["ranks"]):
        assert res[key] is not None and re.search(match, res[key]), (r, res)


# ---------------------------------------------------------------------------
# The zigzag layout and its loader (no gang)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq,ring", [(32, 2), (32, 4), (48, 4), (24, 3)])
def test_zigzag_indices_and_batch_match_the_reference(seq, ring):
    from determined_tpu.data.tokens import zigzag_batch as jbatch
    from determined_tpu.parallel.ring import inverse_permutation as jinv
    from determined_tpu.parallel.ring import zigzag_indices as jzz

    from determined_tpu_torch.data import zigzag_batch
    from determined_tpu_torch.parallel.ring import (
        inverse_permutation,
        zigzag_indices,
    )

    perm = zigzag_indices(seq, ring)
    np.testing.assert_array_equal(perm, jzz(seq, ring))
    assert perm.dtype == jzz(seq, ring).dtype
    np.testing.assert_array_equal(inverse_permutation(perm), jinv(perm))
    raw = np.random.default_rng(seq + ring).integers(0, 99, (3, seq + 1))
    got, want = zigzag_batch(raw, perm), jbatch(raw, perm)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with pytest.raises(ValueError, match="divisible by 2\\*ring"):
        zigzag_indices(seq + 1, ring)


@pytest.mark.parametrize("source", ["synthetic", "shard"])
def test_loader_emits_the_reference_zigzag_stream(tmp_path, source):
    from determined_tpu.data import tokens as jtokens

    from determined_tpu_torch.data import tokens as ttokens

    b, s, ring = 2, 32, 4
    patterns = None
    if source == "shard":
        path = str(tmp_path / "shard0.bin")
        ttokens.write_token_shard(
            path, np.random.default_rng(5).integers(0, 500, 4000))
        patterns = [path]
    got = ttokens.lm_dataset(patterns, b, s, 500, seed=3, zigzag_ring=ring)
    want = jtokens.lm_dataset(patterns, b, s, 500, seed=3, zigzag_ring=ring)
    for _ in range(3):
        g, w = next(got), next(want)
        assert sorted(g) == ["positions", "targets", "tokens"] == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    if source == "shard":
        assert got.zigzag_ring == ring
        got.skip(2)
        want.skip(2)
        np.testing.assert_array_equal(next(got)["targets"],
                                      next(want)["targets"])


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_worker(sys.argv[2], sys.argv[3:])
    else:
        worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
