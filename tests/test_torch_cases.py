"""``launch/cases.py``: the port's ``build_case`` against the reference's,
and its closures run on a mesh, on the CPU.

- Every (arch, shape) of ``assigned_cells(include_paper_model=True)``
  on fake 16×16 and 2×16×16 meshes (repeated host positions; the
  reference builds its case as ``tests/test_distributed.py`` builds its
  meshes, with no compile): the same argument structure, the same
  shape and dtype for every argument (a ``meta`` tensor here, a
  ``ShapeDtypeStruct`` there) and the same ``PartitionSpec`` for every
  sharding. Exact: no tolerance.
- Each case kind (train, prefill, decode) once per family on a reduced
  config and shape at (2, 2), its arguments materialised from a seed
  in f32 and placed by ``cases.place``, run under the dry-run's scope
  (batch rows over "data"; exact reductions and token-parallel MoE
  when serving) against the same closure on the unplaced arguments:
  prefill and decode logits within 1e-5 relative (an MoE prefill
  against the prefills of each data shard's rows, as token parallelism
  routes them), the decode's written slab too; the train step's loss
  and grad norm within 1e-4 and its params within twice the step's lr.
  Also each kind of a dense config whose 6 heads the 4 columns of
  (1, 4) do not divide (the attention whole on the first column).
- The batch-chunked MoE prefill puts its chunks' K/V back in
  ``kv_cache_spec`` layout over the whole batch.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jax.devices()

from _port_cases import (FAMILIES, clone, cpu_mesh, dtype_name,  # noqa
                         fake_meshes, materialize, scope, walk)
from repro.configs import assigned_cells  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import cases  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.base import Family  # noqa: E402

CELLS = assigned_cells(include_paper_model=True)
_JMESH = {}


def jbuild(arch, shape, multi):
    from repro.launch.cases import build_case as jbuild_case
    if multi not in _JMESH:
        _JMESH[multi] = fake_meshes(multi)
    jm, tm = _JMESH[multi]
    return jbuild_case(arch, shape, jm), tm


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_build_case_equals_reference(arch, shape, multi):
    (_, jargs, jsh), tm = jbuild(arch, shape, multi)
    fn, args, sh = cases.build_case(arch, shape, tm)
    assert callable(fn)
    ja, ta = list(walk(jargs)), list(walk(args))
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (path, j), (_, t) in zip(ja, ta):
        if isinstance(j, tuple):                       # no LoRA: ()
            assert t == (), path
            continue
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(j.shape), path
        assert dtype_name(t.dtype) == dtype_name(j.dtype), path
    js, ts = list(walk(jsh)), list(walk(sh))
    assert [p for p, _ in js] == [p for p, _ in ts]
    for (path, j), (_, t) in zip(js, ts):
        if isinstance(j, tuple):
            assert t == (), path
            continue
        assert tuple(t.spec) == tuple(j.spec), (path, t.spec, j.spec)
        assert t.mesh is tm


# ------------------------------------------------------ running a case
RUN = [(f, k) for f in FAMILIES for k in ("train", "prefill", "decode")]
#: Heads the "model" axis does not divide (6 on 4 columns), each kind:
#: the attention whole on the first column.
UNEVEN = [("dense", k) for k in ("train", "prefill", "decode")]
SHAPE = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
B, S = 4, 8


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / max(want.abs().max(), 1.0))


def whole(x):
    if isinstance(x, tsh.ShardedTensor):
        return x.cpu()
    if isinstance(x, (tuple, list)):
        return tuple(whole(t) for t in x)
    return x


def moe_rows(fn, args, n):
    """An MoE prefill's unsharded reference under token parallelism:
    the closure on each data shard's rows, concatenated."""
    params, tokens, lora, idx, extra = args
    outs = []
    for rows in (slice(i * B // n, (i + 1) * B // n) for i in range(n)):
        outs.append(fn(params, tokens[rows], lora, idx[rows],
                       {k: v[rows] for k, v in extra.items()}))
    return (torch.cat([o[0] for o in outs]),
            tuple(torch.cat([o[1][j] for o in outs], 1) for j in range(2)))


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize(
    "family,kind,heads",
    [(f, k, None) for f, k in RUN] + [(f, k, 6) for f, k in UNEVEN],
    ids=[f"{f}-{k}" for f, k in RUN] + [f"{f}-{k}-6heads-1x4"
                                        for f, k in UNEVEN])
def test_case_runs_on_a_mesh(family, kind, heads):
    arch = FAMILIES[family]
    cfg = get_config(arch).reduced()
    mesh = cpu_mesh((2, 2))
    if heads is not None:
        cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=2)
        mesh = cpu_mesh((1, 4))
    # Train: qwen3-moe's 8 microbatches of 2 rows (one a data shard).
    fn, args, sh = cases.build_case(arch, SHAPE[kind], mesh,
                                    16 if kind == "train" else B,
                                    config=cfg, seq_override=S)
    plain = materialize(cfg, kind, args, seed=3)
    placed = cases.place(cfg, kind, clone(plain), sh)
    if kind == "train":
        p_ref, o_ref = clone(plain[0]), clone(plain[1])
        _, _, want = fn(p_ref, o_ref, plain[2])
        with scope(mesh, kind):
            _, _, got = fn(*placed)
        for k in ("loss", "grad_norm"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-4 * max(
                abs(float(want[k])), 1.0), (k, got, want)
        lr = float(want["lr"])
        for k, v in p_ref.items():
            d = (placed[0][k].cpu() - v).abs().max().item()
            assert d <= 2 * lr + 1e-6, (k, d, lr)
        return
    if kind == "prefill" and cfg.family == Family.MOE:
        want = moe_rows(fn, clone(plain), mesh.shape["data"])
    else:
        want = fn(*clone(plain))
    with scope(mesh, kind):
        got = fn(*placed)
    assert rel(got[0], want[0]) <= 1e-5
    for g, w in zip(tsh_leaves(got[1]), tsh_leaves(want[1])):
        assert isinstance(g, tsh.ShardedTensor)
        assert rel(whole(g), w) <= 1e-5


def tsh_leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tsh_leaves(t)]
    return [tree]


@pytest.mark.filterwarnings("ignore:fit_spec")
def test_chunked_moe_prefill_puts_kv_back_in_slab_layout():
    """B 32 makes ``n_mb`` 2 for qwen3-moe: two chunks' prefills whose
    K/V come back over the whole batch, in ``kv_cache_spec`` layout,
    equal to the chunks' unsharded prefills (each chunk's data shards
    routing their own rows)."""
    arch = FAMILIES["moe"]
    cfg = get_config(arch).reduced()
    mesh = cpu_mesh((2, 1))
    Bc = 32
    fn, args, sh = cases.build_case(arch, "prefill_32k", mesh, Bc,
                                    config=cfg, seq_override=4)
    plain = materialize(cfg, "prefill", args, seed=4)
    placed = cases.place(cfg, "prefill", clone(plain), sh)
    with scope(mesh, "prefill"):
        logits, kv = fn(*placed)
    params, tokens, lora, idx, extra = plain
    outs = [api.prefill(cfg, params, tokens[r], lora=lora,
                        adapter_idx=idx[r])
            for r in (slice(i * 8, (i + 1) * 8) for i in range(4))]
    want = torch.cat([o[0] for o in outs])
    assert rel(logits, want) <= 1e-5
    for j, st in enumerate(kv):
        assert tuple(st.sharding.spec) == tuple(
            tsh.kv_cache_spec(mesh, st.shape))
        assert st.shape[1] == Bc
        assert rel(st.cpu(), torch.cat([o[1][j] for o in outs], 1)) <= 1e-5
