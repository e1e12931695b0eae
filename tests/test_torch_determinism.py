"""Guard: no op on the port's step paths adds floats in an order that can
change from run to run on a CUDA card.

A ``TorchDispatchMode`` records every aten op of a tiny init, split and
seq tick on the CPU (init and split also on an unstructured grid) (forward, backward and the eikonal double backward),
of one validation half and of one pbr forward + backward, and fails on
any op that PyTorch documents as nondeterministic on CUDA
(``torch.use_deterministic_algorithms``) when it takes a floating tensor;
a plain write (``scatter``, ``index_copy``, ``index_put`` without
accumulation) only where two writes land on one element.
The plain versions of the port's kernels (``coo_scatter_add_plain``,
``first_k_plain``, ``resolve_tiles_plain``, ``inclusive_scan_plain``) are
exempt: on a card their kernels run instead, so the mode pauses inside
them. The other half of the guarantee, cuDNN's deterministic
convolutions, is ``configure_backends``'s.
"""

import contextlib
import functools

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from d3human_tpu_torch.ops import compaction, raster_resolve, scan, scatter

torch.set_num_threads(1)

aten = torch.ops.aten

# ops nondeterministic on CUDA whatever their arguments (a floating tensor
# among them)
ALWAYS = {
    aten.index_add.default, aten.index_add_.default, aten.index_add.out,
    aten.scatter_add.default, aten.scatter_add_.default,
    aten.scatter_add.out,
    aten.put.default, aten.put_.default,
    aten.histc.default, aten.embedding_dense_backward.default,
    aten.upsample_bilinear2d_backward.default,
    aten.upsample_linear1d_backward.default,
    aten.upsample_bicubic2d_backward.default,
    aten.upsample_trilinear3d_backward.default,
    aten.upsample_nearest2d_backward.default,
    aten.grid_sampler_2d_backward.default,
    aten.grid_sampler_3d_backward.default,
    aten._adaptive_avg_pool2d_backward.default,
    aten.adaptive_max_pool2d_backward.default,
    aten.avg_pool3d_backward.default,
    aten.max_pool3d_with_indices_backward.default,
    aten.reflection_pad1d_backward.default,
    aten.reflection_pad2d_backward.default,
    aten.replication_pad1d_backward.default,
    aten.replication_pad2d_backward.default,
    aten.nll_loss_forward.default, aten.nll_loss2d_forward.default,
}
# ops nondeterministic with a floating input: a scan, and the reductions
# of a scatter
FLOAT_SCANS = {aten.cumsum.default, aten.cumsum_.default, aten.cumsum.out}
SCATTER_REDUCE = {aten.scatter_reduce.two, aten.scatter_reduce_.two,
                  aten.scatter_reduce.two_out}
INDEX_PUT = {aten.index_put.default, aten.index_put_.default,
             aten._index_put_impl_.default, aten._index_put_impl.default}
# plain writes: nondeterministic only where two writes land on one element
# (which one wins is the order of the threads)
WRITES = {aten.scatter.src, aten.scatter_.src,
          aten.index_copy.default, aten.index_copy_.default}


def _repeats(x: torch.Tensor, dim: int = 0) -> bool:
    """True if ``x`` repeats a value along ``dim`` (rows of ``x`` moved to
    the front are compared whole)."""
    x = x.movedim(dim, 0).reshape(x.shape[dim], -1)
    s = x.sort(dim=0).values
    return bool((s[1:] == s[:-1]).any())


def _index_put_repeats(indices) -> bool:
    ints = [i for i in indices if i is not None and not i.dtype == torch.bool]
    if not ints:
        return False
    pos = torch.stack(torch.broadcast_tensors(*ints), -1).reshape(
        -1, len(ints))
    return pos.unique(dim=0).shape[0] < pos.shape[0]


def _floats(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_floating_point()
               for a in torch.utils._pytree.tree_leaves(args))


def offending(func, args, kwargs) -> bool:
    """True for an op PyTorch lists as nondeterministic on CUDA, called
    with a floating tensor."""
    if not _floats((args, kwargs)):
        return False
    if func in ALWAYS or func in FLOAT_SCANS:
        return True
    if func in SCATTER_REDUCE:
        return (kwargs.get("reduce", args[3] if len(args) > 3 else None)
                in ("sum", "mean"))
    if func in INDEX_PUT:
        acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        return bool(acc) or _index_put_repeats(args[1])
    if func is aten.bincount.default:
        return (kwargs.get("weights", args[1] if len(args) > 1 else None)
                is not None)
    if func in WRITES:
        dim, index = args[1], args[2]
        if func in (aten.index_copy.default, aten.index_copy_.default):
            return _repeats(index)
        return _repeats(index, dim % index.dim())
    return False


class NondeterminismRecorder(TorchDispatchMode):
    """Records the offending ops by name; paused while ``depth`` > 0."""

    def __init__(self):
        super().__init__()
        self.found = {}
        self.depth = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.depth == 0:
            self.ops += 1
            if offending(func, args, kwargs):
                name = str(func.overloadpacket.__name__)
                self.found[name] = self.found.get(name, 0) + 1
        return func(*args, **kwargs)


PLAIN = ((scatter, "coo_scatter_add_plain"),
         (compaction, "first_k_plain"),
         (raster_resolve, "resolve_tiles_plain"),
         (scan, "inclusive_scan_plain"))


@contextlib.contextmanager
def recording(monkeypatch):
    """The recorder active, paused inside every kernel's plain version."""
    rec = NondeterminismRecorder()
    for mod, name in PLAIN:
        fn = getattr(mod, name)

        @functools.wraps(fn)
        def paused(*a, _fn=fn, **k):
            rec.depth += 1
            try:
                return _fn(*a, **k)
            finally:
                rec.depth -= 1
        monkeypatch.setattr(mod, name, paused)
    with rec:
        yield rec


@pytest.fixture(scope="module")
def scene():
    sc = chip_smoke.build_scene("tiny", "cpu", seed_steps=30)
    chip_smoke.add_seq(sc, "tiny")
    return sc


def _step(sc, stage):
    """One training step of ``stage`` (forward, backward with the eikonal
    double backward, Adam) on a copy of the scene's parameters."""
    from d3human_tpu_torch.train.step import init_state

    cfg = chip_smoke.stage_cfg(sc, stage)[0]
    sc = dict(sc, params=chip_smoke.clone_tree(sc["params"]))
    state = init_state(stage, sc["params"], cfg)
    gen = torch.Generator().manual_seed(0)
    state, m = chip_smoke.stage_step_fn(sc, stage)(state, sc["target"], gen)
    chip_smoke.check_step_metrics(stage, chip_smoke.scalars(m), stage)


def _unstructured(sc):
    """The scene on its lattice's verts and tets as an unstructured grid
    (the reference format's gather branches of the extraction and of
    ``sdf_reg_loss``)."""
    from d3human_tpu_torch.ops.tet_grid import unstructured

    return chip_smoke.on_grid(sc, unstructured(sc["model"].grid))


def _pyramid_step(sc):
    """An init step with the weight-free pyramid perceptual loss
    (``loss.perceptual_backbone = "pyramid"``)."""
    from d3human_tpu_torch.models.perceptual import PyramidPerceptual

    _step(dict(sc, perceptual=PyramidPerceptual(), perc_params={}), "init")


def _validation(sc):
    chip_smoke.validation_render(sc, 1.0, torch.Generator().manual_seed(2))


def _pbr(sc):
    """One pbr forward + backward, as ``chip_smoke.phase_pbr`` takes it."""
    H, W = sc["cfg"].render.train_res
    gen = torch.Generator().manual_seed(9)
    wts = torch.randn((H, W, 10), generator=gen)
    light, mat = chip_smoke.pbr_inputs(sc, seed=10)
    buf = chip_smoke.pbr_render(sc, light, mat, generator=gen)
    chip_smoke.pbr_loss(buf, wts).backward()


PATHS = {"init": functools.partial(_step, stage="init"),
         "split": functools.partial(_step, stage="split"),
         "seq": functools.partial(_step, stage="seq"),
         "init_pyramid": _pyramid_step,
         "init_unstructured": lambda sc: _step(_unstructured(sc), "init"),
         "split_unstructured": lambda sc: _step(_unstructured(sc), "split"),
         "validate": _validation,
         "pbr": _pbr}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_path_has_no_nondeterministic_op(scene, monkeypatch, path):
    with recording(monkeypatch) as rec:
        PATHS[path](scene)
    assert rec.ops > 1000, f"{path}: only {rec.ops} ops recorded"
    assert rec.found == {}, (f"{path}: ops nondeterministic on CUDA: "
                             f"{rec.found}")


def test_recorder_sees_each_kind(monkeypatch):
    """The recorder flags each kind of offending op and exempts the plain
    versions of the kernels."""
    x = torch.rand(6, 3, requires_grad=True)
    idx = torch.tensor([0, 2, 2, 5])
    with recording(monkeypatch) as rec:
        x[idx].sum().backward()                           # index_put acc
        torch.zeros(6, 3).index_add(0, idx, torch.ones(4, 3))
        torch.cumsum(torch.rand(5), 0)
        torch.cumsum(torch.arange(5), 0)                 # ints: fine
        torch.nn.functional.interpolate(
            torch.rand(1, 1, 3, 3, requires_grad=True), size=(5, 5),
            mode="bilinear", align_corners=False).sum().backward()
        torch.zeros(6, 3).index_copy(0, idx, torch.ones(4, 3))
        torch.zeros(6, 3).index_copy(0, idx.unique(), torch.ones(3, 3))
        x.detach().max(dim=-1).values                     # fine
        x.max(dim=-1).values.sum().backward()             # unique: fine
        scatter.coo_scatter_add_plain(idx, torch.ones(4, 3), 6)
        scan.inclusive_scan_plain(torch.rand(7))
    assert rec.found == {"index_put": 1, "index_add": 1, "cumsum": 1,
                         "upsample_bilinear2d_backward": 1,
                         "index_copy": 1}, rec.found


def test_configure_backends_sets_deterministic_cudnn():
    from d3human_tpu_torch.utils.backend import configure_backends

    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        configure_backends()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
        assert not torch.are_deterministic_algorithms_enabled()
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


@pytest.mark.parametrize("size", [(7, 9), (8, 10), (23, 24), (2, 3), (48, 48)])
def test_upsample_bilinear_equals_interpolate(size):
    """The pyramid's upsample by weight matrices equals ``F.interpolate``
    (bilinear, align_corners=False) within 1e-6 from half size, odd and
    even, and so do its gradients."""
    from d3human_tpu_torch.models.perceptual import upsample_bilinear

    gen = torch.Generator().manual_seed(sum(size))
    x = torch.rand((2, 3, -(-size[0] // 2), -(-size[1] // 2)), generator=gen,
                   requires_grad=True)
    g = torch.rand((2, 3, *size), generator=gen)
    want = torch.nn.functional.interpolate(x, size=size, mode="bilinear",
                                           align_corners=False)
    (gw,) = torch.autograd.grad((want * g).sum(), x)
    got = upsample_bilinear(x, size)
    (gg,) = torch.autograd.grad((got * g).sum(), x)
    assert float((got - want).detach().abs().max()) <= 1e-6
    assert float((gg - gw).abs().max()) <= 1e-5


def test_random_crop_pair_is_the_slice():
    """The crop by one row gather equals the slice, corner clamped into the
    image as a dynamic slice clamps it, and so does its gradient."""
    from d3human_tpu_torch.models.perceptual import random_crop_pair

    gen = torch.Generator().manual_seed(0)
    a = torch.rand((2, 13, 11, 3), generator=gen, requires_grad=True)
    b = torch.rand((2, 13, 11, 3), generator=gen)
    for (top, left), crop in (((3, 2), 6), ((12, 10), 6), ((0, 0), 20)):
        ca, cb = random_crop_pair(None, a, b, crop, offsets=(top, left))
        ch, cw = min(crop, 13), min(crop, 11)
        t, lf = min(top, 13 - ch), min(left, 11 - cw)
        assert torch.equal(ca, a[:, t:t + ch, lf:lf + cw])
        assert torch.equal(cb, b[:, t:t + ch, lf:lf + cw])
        (g,) = torch.autograd.grad(ca.sum(), a)
        want = torch.zeros_like(a)
        want[:, t:t + ch, lf:lf + cw] = 1.0
        assert torch.equal(g, want)


def test_inclusive_scan_plain_is_cumsum():
    """On the CPU the scan is ``torch.cumsum`` along the last axis, for a
    vector and for rows, detached."""
    x = torch.rand((5, 300), generator=torch.Generator().manual_seed(1),
                   requires_grad=True)
    assert torch.equal(scan.inclusive_scan(x), torch.cumsum(x.detach(), -1))
    assert torch.equal(scan.inclusive_scan(x[0]),
                       torch.cumsum(x[0].detach(), 0))
    assert not scan.inclusive_scan(x).requires_grad
