"""The port's sharding rule table, ShardPlan and meshes vs the JAX
package's.

The rule table (``distributed/sharding.py``) and ``ShardPlan`` are pure
metadata, so both packages run on fake meshes over repeated host
devices (``tests/test_distributed.py``'s ``fake_mesh``) and must give
the same PartitionSpec for every config, step kind, parameter and mesh
(compared entry by entry; no tolerance, specs are exact). Then the
port's own pieces: the mesh factories' validation messages, ``fit_spec``
warn-once, ``MeshPlan.make``, the activation-sharding scope, and a
shard-then-gather round trip that must be bit-exact. The CPU's mesh
positions come from ``XLA_FLAGS`` as in JAX; the tests set it where they
need more than one.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
# JAX reads XLA_FLAGS once, when its backend starts: start it now, so
# the XLA_FLAGS these tests set for the port never reach JAX.
jax.devices()
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models.base import param_shapes as jparam_shapes  # noqa: E402
from repro.serving.shard_plan import ShardPlan as JShardPlan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import act_sharding as acts  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed.elastic import plan_after_failure  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_host_mesh,  # noqa: E402
                                     make_production_mesh,
                                     make_serving_mesh)
from repro_torch.models.base import param_shapes  # noqa: E402
from repro_torch.serving.shard_plan import ShardPlan  # noqa: E402

P = tsh.PartitionSpec
FORCE = "--xla_force_host_platform_device_count={}"
SHAPES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x2": ((1, 2), ("data", "model"))}


def meshes(name):
    """The JAX fake mesh and the port's, same shape and axes."""
    shape, axes = SHAPES[name]
    n = int(np.prod(shape))
    jdev = np.asarray(jax.devices()[:1] * n).reshape(shape)
    tdev = np.empty(n, dtype=object)
    tdev[:] = [torch.device("cpu")] * n
    return JMesh(jdev, axes), Mesh(tdev.reshape(shape), axes)


def same(tspec, jspec) -> bool:
    return tuple(tspec) == tuple(jspec)


# ------------------------------------------------------------- fit_spec
FIT_CASES = [((32, 64), ("data", "model"), "16x16"),
             ((32, 30), ("data", "model"), "16x16"),
             ((8, 30), ("data", "model"), "16x16"),
             ((2, 64), (("pod", "data"), None), "2x16x16"),
             ((1, 100), (("pod", "data"), None), "2x16x16"),
             ((64, 32), (("pod", "data"), "model"), "2x16x16"),
             ((4, 3), ("data", "model"), "2x2"),
             ((3, 8), ("model", None), "2x2"),
             ((6, 4, 2), (None, "data", "model"), "1x2")]


@pytest.mark.parametrize("shape,spec,mesh", FIT_CASES)
def test_fit_spec_equals_jax(shape, spec, mesh):
    jm, tm = meshes(mesh)
    assert same(tsh.fit_spec(shape, P(*spec), tm),
                jsh.fit_spec(shape, JP(*spec), jm))


def test_fit_spec_never_invalid():
    jm, tm = meshes("16x16")
    for dim in range(1, 300):
        got = tsh.fit_spec((dim,), P("model"), tm)
        assert same(got, jsh.fit_spec((dim,), JP("model"), jm))
        assert got == P("model") if dim % 16 == 0 else got == P()


class TestFitSpecWarnOnce:
    def test_warns_once_per_tensor(self, monkeypatch):
        monkeypatch.setenv("XLA_FLAGS", FORCE.format(4))
        mesh = make_serving_mesh(2, 2, device="cpu")
        shape, spec = (3, 8), P("model", None)   # 3 % 2 != 0 -> dropped
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            first = tsh.fit_spec(shape, spec, mesh, warn_label="t_odd")
            again = tsh.fit_spec(shape, spec, mesh, warn_label="t_odd")
        assert first == P() and again == P()
        msgs = [str(x.message) for x in w if "t_odd" in str(x.message)]
        assert len(msgs) == 1, "fit_spec should warn once per tensor"
        assert "replicated" in msgs[0]

    def test_silent_without_label(self, monkeypatch):
        monkeypatch.setenv("XLA_FLAGS", FORCE.format(4))
        mesh = make_serving_mesh(2, 2, device="cpu")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tsh.fit_spec((5, 8), P("model", None), mesh)
        assert not [x for x in w if "fit_spec" in str(x.message)]


# ------------------------------------------------------------ the rules
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_equals_jax(arch):
    """Every parameter of the published config, train/prefill/decode,
    on (16,16), (2,16,16), (2,2) and (1,2): the raw spec and the fitted
    one of ``param_shardings``."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    shapes = param_shapes(cfg)
    assert shapes == jparam_shapes(jcfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for mesh in SHAPES:
            jm, tm = meshes(mesh)
            for kind in ("train", "prefill", "decode"):
                tfit = tsh.param_shardings(cfg, shapes, tm, kind)
                jfit = jsh.param_shardings(jcfg, shapes, jm, kind)
                for path, shape in shapes.items():
                    assert same(tsh.param_spec(path, shape, cfg, tm, kind),
                                jsh.param_spec(path, shape, jcfg, jm,
                                               kind)), (path, mesh, kind)
                    assert same(tfit[path].spec, jfit[path].spec), \
                        (path, mesh, kind)
                if kind == "train":
                    topt = tsh.opt_shardings(tfit, tm)
                    jopt = jsh.opt_shardings(jfit, jm)
                    assert topt.keys() == jopt.keys()
                    assert all(same(topt[k].spec, jopt[k].spec)
                               for k in topt)


STATE_SHAPES = [(38, 128, 32768, 32, 64), (88, 128, 32768, 1, 128),
                (64, 128, 32768, 8, 128), (4, 1, 30, 3, 8),
                (4, 6, 16, 2, 32), (2, 2, 9, 1, 4)]


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_state_specs_equal_jax(mesh):
    """KV (dense and paged, MQA's sequence fallback and replicated
    heads), SSM, conv, LoRA and batch specs."""
    jm, tm = meshes(mesh)
    for shape in STATE_SHAPES:
        assert same(tsh.kv_cache_spec(tm, shape),
                    jsh.kv_cache_spec(jm, shape)), shape
        assert same(tsh.kv_pages_spec(tm, shape),
                    jsh.kv_pages_spec(jm, shape)), shape
        assert same(tsh.ssm_state_spec(tm, shape[:4]),
                    jsh.ssm_state_spec(jm, shape[:4])), shape
        assert same(tsh.conv_state_spec(tm, shape[:4]),
                    jsh.conv_state_spec(jm, shape[:4])), shape
    for proj in ("q", "k", "v", "o"):
        for which in ("a", "b"):
            assert same(tsh.lora_spec(proj, which, tm),
                        jsh.lora_spec(proj, which, jm))
    for kind in ("train", "decode"):
        assert same(tsh.batch_spec(kind, tm), jsh.batch_spec(kind, jm))


def test_mqa_kv_falls_back_to_sequence():
    _, tm = meshes("16x16")
    assert tsh.kv_cache_spec(tm, (88, 128, 32768, 1, 128)) == \
        P(None, "data", "model")
    assert tsh.kv_pages_spec(tm, (88, 4096, 16, 1, 128)) == P(None, "data")


# ------------------------------------------------------------ ShardPlan
@pytest.mark.parametrize("mesh", ["2x2", "1x2", "16x16"])
@pytest.mark.parametrize("arch", ["chameleon-llama-7b", "granite-34b",
                                  "qwen2.5-32b"])
def test_shard_plan_equals_jax(arch, mesh):
    """Every ShardPlan method, at the engine's shapes."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jm, tm = meshes(mesh)
    jp, tp = JShardPlan(jm, jcfg), ShardPlan(tm, cfg)
    assert (tp.data_size, tp.model_size) == (jp.data_size, jp.model_size)
    shapes = param_shapes(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tparams, jparams = tp.params(shapes), jp.params(shapes)
        assert all(same(tparams[k].spec, jparams[k].spec) for k in shapes)
        L, S, r = cfg.n_layers, 8, 32
        slots = {"q": ((L, S, cfg.d_model, r), (L, S, r, cfg.q_dim)),
                 "k": ((L, S, cfg.d_model, r), (L, S, r, cfg.kv_dim)),
                 "o": ((L, S, cfg.q_dim, r), (L, S, r, cfg.d_model))}
        arr = {p: tuple(np.zeros(s, np.int8) for s in ab)
               for p, ab in slots.items()}
        tl, jl = tp.lora_slots(arr), jp.lora_slots(arr)
        host = {p: (a[:, 0], b[:, 0]) for p, (a, b) in arr.items()}
        ta, ja = tp.adapter_weights(host), jp.adapter_weights(host)
        for p in slots:
            for i in range(2):
                assert same(tl[p][i].spec, jl[p][i].spec)
                assert same(ta[p][i].spec, ja[p][i].spec)
    kv = (L, 4098, 16, cfg.n_kv_heads, cfg.head_dim)
    slab = (L, 8, 256, cfg.n_kv_heads, cfg.head_dim)
    assert same(tp.kv_pages(kv).spec, jp.kv_pages(kv).spec)
    assert same(tp.kv_dense(slab).spec, jp.kv_dense(slab).spec)
    for shape in ((8,), (8, 1), (1,), (8, 3), (1, 64)):
        assert same(tp.batch(shape).spec, jp.batch(shape).spec)
    for shape in ((8, 8), (4, 1)):
        assert same(tp.horizon(shape).spec, jp.horizon(shape).spec)
    for shape in ((8, cfg.vocab_size), (1, cfg.vocab_size)):
        assert same(tp.logits(shape).spec, jp.logits(shape).spec)
    assert same(tp.replicated.spec, jp.replicated.spec)


# --------------------------------------------------------------- meshes
class TestMakeServingMesh:
    def test_shapes_and_axes(self, monkeypatch):
        monkeypatch.setenv("XLA_FLAGS", FORCE.format(4))
        mesh = make_serving_mesh(2, 1, device="cpu")
        assert mesh.axis_names == ("data", "model")
        assert dict(mesh.shape) == {"data": 2, "model": 1}
        mesh = make_serving_mesh(2, 2, device="cpu")
        assert dict(mesh.shape) == {"data": 1, "model": 2}
        assert mesh.size == 2 and mesh.devices.shape == (1, 2)

    @pytest.mark.parametrize("args", [(0, 1), (2, 0), (3, 2), (2, 1)])
    def test_messages_equal_jax(self, args, monkeypatch):
        """Positive, divide, and too many devices: the same
        ValueError text as the JAX factory (both see one CPU device)."""
        from repro.launch.mesh import make_serving_mesh as jmake
        monkeypatch.delenv("XLA_FLAGS", raising=False)
        assert len(jax.devices()) == 1
        with pytest.raises(ValueError) as jerr:
            jmake(*args)
        with pytest.raises(ValueError) as terr:
            make_serving_mesh(*args, device="cpu")
        assert str(terr.value) == str(jerr.value)

    def test_cards_count_visible_devices(self, monkeypatch):
        """On the card the positions are cuda:0..n-1, and a mesh wants
        no more than ``torch.cuda.device_count()``."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        mesh = make_serving_mesh(2, 2, device="cuda")
        assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"]
        with pytest.raises(ValueError, match="only 2 are available"):
            make_serving_mesh(4, 2, device="cuda")

    def test_host_and_production_meshes(self, monkeypatch):
        monkeypatch.setenv("XLA_FLAGS", FORCE.format(512))
        assert dict(make_host_mesh("cpu").shape) == {"data": 512,
                                                     "model": 1}
        assert dict(make_production_mesh(device="cpu").shape) == \
            {"data": 16, "model": 16}
        mp = make_production_mesh(multi_pod=True, device="cpu")
        assert mp.axis_names == ("pod", "data", "model")
        monkeypatch.setenv("XLA_FLAGS", FORCE.format(8))
        with pytest.raises(ValueError, match="devices"):
            make_production_mesh(device="cpu")

    def test_mesh_plan_make(self, monkeypatch):
        monkeypatch.setenv("XLA_FLAGS", FORCE.format(256))
        plan = plan_after_failure((16, 16), ("data", "model"), 224, 256)
        mesh = plan.make(device="cpu")
        assert mesh.axis_names == ("data", "model")
        assert tuple(mesh.shape.values()) == plan.shape == (14, 16)
        assert mesh.size == plan.n_devices


# ------------------------------------------------- placement round trip
ROUND_TRIP = [((6, 8, 4), (None, "data", "model"), "2x2"),
              ((4, 6), ("model",), "1x2"),
              ((4, 6), (("data", "model"),), "2x2"),
              ((2, 3, 16), (None, None, "model"), "16x16"),
              ((32, 2, 8), (("pod", "data"), None, "model"), "2x16x16"),
              ((5, 7), (), "2x2")]


@pytest.mark.parametrize("shape,spec,mesh", ROUND_TRIP)
def test_shard_then_gather_is_bit_exact(shape, spec, mesh):
    _, tm = meshes(mesh)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    # A block that is x (or a contiguous view of it) on its device is
    # not copied: shard a copy, since the writes below go through.
    st = tsh.NamedSharding(tm, tsh.fit_spec(shape, P(*spec), tm)).shard(
        x.clone())
    assert torch.equal(st.full(), x)
    # Positions that hold the same block on one device share a tensor;
    # the blocks cover x exactly once.
    cover = torch.zeros(shape)
    seen = set()
    for slc, t in st.unique():
        key = tuple((s.start, s.stop) for s in slc)
        assert torch.equal(t, x[slc])
        if key not in seen:
            seen.add(key)
            cover[slc] += 1
    assert torch.equal(cover, torch.ones(shape))
    # Writes land in every shard that holds the row; copy_ in place.
    y = x.clone()
    y[1] = 7.0
    st[1] = 7.0
    assert torch.equal(st.full(), y)
    st.copy_(-x)
    assert torch.equal(st.full(), -x)


def test_uneven_split_is_refused():
    _, tm = meshes("2x2")
    with pytest.raises(ValueError, match="fit_spec"):
        tsh.NamedSharding(tm, P("data")).shard(torch.zeros(3))


def test_kv_pages_zeros_keep_a_write_sink():
    _, tm = meshes("2x2")
    cfg = get_config("chameleon-llama-7b").reduced()
    plan = ShardPlan(tm, cfg)
    shape = (cfg.n_layers, 8, 16, cfg.n_kv_heads, cfg.head_dim)
    st = plan.zeros_kv_pages(shape, torch.float32)
    for _, t in st.unique():
        assert t.shape[1] == 4 and st.raw(t).shape[1] == 5
    assert st.full().shape == shape


# ------------------------------------------------ activation sharding
def test_activation_sharding_refuses_unported_modes():
    """The sequence-parallel boundary is ported (the scope installs it
    for the train step's residual); the serving exact mode with the
    batch axes computes batch rows (one a row of positions, a batch
    they do not divide whole on the first row), and the row-parallel
    mode with the batch axes (training) is ported."""
    _, tm = meshes("2x2")
    with acts.activation_sharding(("data",), mesh=tm,
                                  seq_shard_boundary=True):
        assert acts.seq_shard_boundary()
    assert not acts.seq_shard_boundary()
    with acts.activation_sharding(("data",), mesh=tm,
                                  exact_reductions=True):
        assert acts.row_spans(4) == [(0, 0, 2), (1, 2, 4)]
        assert acts.row_spans(3) == [(0, 0, 3)]
    with acts.activation_sharding((), mesh=tm, exact_reductions=True):
        assert acts.row_spans(4) == [(0, 0, 4)]
    with acts.activation_sharding(("data",), mesh=tm):
        assert acts.installed_mesh() is tm


def test_gather_points_do_nothing_without_a_mesh():
    x = torch.randn(2, 3, 4, 8)
    assert acts.installed_mesh() is None
    for f in (acts.constrain_logits, acts.constrain_heads,
              acts.constrain_ffn_hidden, acts.constrain_attn_merged,
              acts.constrain_residual):
        assert f(x) is x
    assert acts.replicate(x) == [x]


def test_gather_points_split_and_gather_columns():
    from repro_torch.kernels.ops import COLLECTIVE_METER
    _, tm = meshes("2x2")
    x = torch.randn(2, 3, 4, 8)
    COLLECTIVE_METER.reset()
    with acts.activation_sharding((), mesh=tm, exact_reductions=True):
        assert acts.installed_mesh() is tm
        cols = acts.constrain_heads(x)
        assert [c.shape for c in cols] == [(2, 3, 2, 8)] * 2
        merged = [c.reshape(2, 3, 16) for c in cols]
        for f in (acts.constrain_attn_merged, acts.constrain_ffn_hidden,
                  acts.constrain_residual, acts.constrain_logits):
            assert torch.equal(f(merged), x.reshape(2, 3, 32))
        assert len(acts.replicate(x)) == 2
    assert acts.installed_mesh() is None
    assert COLLECTIVE_METER.gathers == 4
