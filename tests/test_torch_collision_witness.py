"""A float64 witness of the cloth-body collision loss's gradient: the port's
``collision_loss`` and the benchmark's plain reference
(``d3h_bench/reference/models/geometry.py``), each in float32, against the
same loss in float64 on the same posed seq template.

The loss picks each cloth vertex's nearest body face centre, and on the
subdivided template many centres tie in exact arithmetic; float32 and
float64 then break the ties apart and the two losses differ by whole faces,
not by rounding. So the witness holds the search's winners fixed: each side's
own float32 ``knn1`` winners (both sides run the same search and must agree
on them) go into the float64 loss, and each side's gradient is measured
against that loss's gradient. The port's gap from float64 has to be within
10x the reference's.

The CPU test runs a small template; the card test, ``-m cuda``, the
``f3c_seq`` cell's template (74,333 cloth vertices against 244,171 body
faces). The file imports no JAX:

    python -m pytest --noconftest -m cuda -s tests/test_torch_collision_witness.py
"""

import json
import os
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WITHIN = 10.0       # the port's gap over the reference's, at most
POSE_SEED = 2 ** 33 + 41


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the scatter kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _posed_template(config: str, root: str, n_subdiv: int, target_faces,
                    device):
    """The seq template of ``config``'s synthetic body at ``n_subdiv`` /
    ``target_faces``, and its vertices posed by LBS at frame 0 (the first
    seq step's positions with the offsets at zero)."""
    from d3h_bench import registry
    from d3h_bench.inputs import _scene
    from d3h_bench.reference.config import load_config
    from d3h_bench.reference.data.synthetic import seq_bench_template

    cfg = load_config(registry.config_path(config, root))
    scene = _scene(cfg, 1, POSE_SEED, device)
    host = seq_bench_template(scene, n_subdiv=n_subdiv,
                              target_faces=target_faces, device="cpu")
    t = types.SimpleNamespace(**{k: getattr(host, k).to(device) for k in (
        "v", "cloth_vidx", "body_vidx", "body_f")})
    with torch.no_grad():
        pos = scene.deformer.lbs_forward(scene.canon, t.v, scene.pose_params,
                                         0)
    return t, pos


def _loss64(cloth, body, faces, idx, eps):
    """The collision hinge in float64 with the nearest centres ``idx``
    given (ref hmsdf.py:98-132)."""
    faces = faces.long().clamp(0, body.shape[0] - 1)
    tri = body[faces]
    centers = (tri[:, 0] + tri[:, 1] + tri[:, 2]) / 3.0
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                           dim=-1)
    n = n / torch.sqrt(torch.clamp_min((n * n).sum(-1, keepdim=True), 1e-20))
    d = ((cloth - centers[idx]) * n[idx]).sum(-1)
    inter = torch.relu(eps - d)
    return (inter * inter).mean()


def _grad(fn, pos, t, *args):
    p = pos.detach().clone().requires_grad_(True)
    loss = fn(p[t.cloth_vidx.long()], p[t.body_vidx.long()], t.body_f,
              *args)
    (g,) = torch.autograd.grad(loss, p)
    return loss.detach(), g


def witness(t, pos, eps: float = 0.005) -> dict:
    """Each side's float32 loss and gradient, its gap from the float64
    gradient at its own winners (relative L2 over the template's
    vertices), and whether the two sides' winners agree."""
    from d3h_bench.reference.models import geometry as ref_geometry
    from d3human_tpu_torch.models import geometry as port_geometry

    out = {}
    for side, mod in (("port", port_geometry), ("reference", ref_geometry)):
        inner, got = mod.knn1, {}

        def knn1(q, r, *a, **kw):
            d, idx = inner(q, r, *a, **kw)
            got["idx"] = idx
            return d, idx

        mod.knn1 = knn1
        try:
            loss, g = _grad(mod.collision_loss, pos, t, eps)
        finally:
            mod.knn1 = inner
        loss64, g64 = _grad(_loss64, pos.double(), t, got["idx"], eps)
        out[side] = dict(
            idx=got["idx"], loss=float(loss), loss64=float(loss64),
            gap=float(torch.linalg.vector_norm(g.double() - g64)
                      / torch.linalg.vector_norm(g64)))
    same = torch.equal(out["port"].pop("idx"), out["reference"].pop("idx"))
    return dict(out, same_winners=same,
                cloth=int(t.cloth_vidx.shape[0]),
                body_faces=int(t.body_f.shape[0]))


def _check(w: dict) -> None:
    print("collision witness " + json.dumps(w), flush=True)
    assert w["same_winners"]
    assert w["reference"]["gap"] > 0.0
    assert w["port"]["gap"] <= WITHIN * w["reference"]["gap"], w


def test_collision_gradient_against_float64_on_the_cpu():
    torch.set_num_threads(2)
    data = os.path.join(ROOT, "d3h_bench", "tests", "data")
    t, pos = _posed_template("tiny", data, 3, None, torch.device("cpu"))
    w = witness(t, pos)
    assert w["cloth"] == 6720 and w["body_faces"] == 22176
    _check(w)


@pytest.mark.cuda
def test_collision_gradient_against_float64_at_the_cell_size(cuda_device):
    from d3h_bench import registry

    spec = registry.config("f3c_seq")["bench"]["seq_template"]
    t, pos = _posed_template("f3c_seq", os.path.join(ROOT, "d3h_bench"),
                             spec["n_subdiv"], spec["target_faces"],
                             cuda_device)
    w = witness(t, pos)
    assert w["cloth"] == 74333 and w["body_faces"] == 244171
    _check(w)
