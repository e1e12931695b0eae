"""The hybrid human model (counterpart of
``d3human_tpu/models/geometry.py``): SDF MLP + mSDF G-Shell geometry posed
by SMPL-X LBS for the init and split stages, and the seq stage's nonrigid
refinement of an explicit merged body+cloth template (``SeqTemplate``,
``seq_deformed``, ``collision_loss``), and the fields' set-up between
stages (``smpl_template_sdf``, ``pretrain_sdf``, ``pretrain_nonrigid_zero``,
``reinit_fields``).

Parameters are a dict of tensors in the JAX package's tree: ``sdf_net``
(MLP layers), ``msdf`` and ``deform`` per lattice vertex, the nonrigid
DeformMLPs ``nonrigid`` (read by seq) and ``body_nonrigid``, the per-frame
latents ``cond`` / ``render_cond`` and the pose code ``fix_code``. No step
reads ``body_nonrigid``, ``cond`` or ``render_cond``; they keep the
optimizer's groups as the reference has them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from d3human_tpu_torch.config import Config
from d3human_tpu_torch.models.fields import MLP, DeformMLP
from d3human_tpu_torch.models.smplx.deformer import (
    CanonicalState, SMPLXDeformer,
)
from d3human_tpu_torch.ops import mesh_ops
from d3human_tpu_torch.ops.knn import knn1
from d3human_tpu_torch.ops.marching_tets import (
    GShellMesh, gshell_extract, gshell_extract_pair,
)
from d3human_tpu_torch.ops.mesh_sdf import mesh_sdf
from d3human_tpu_torch.ops.scatter import gather_rows
from d3human_tpu_torch.ops.tet_grid import TetGrid
from d3human_tpu_torch.utils.logging import span

Params = dict


class ExtractedMeshes(NamedTuple):
    mesh: GShellMesh
    sdf: torch.Tensor             # [N] field values on the deformed grid
    verts_posed: torch.Tensor     # [MV+4MT, 3]
    verts_template: torch.Tensor  # [MV+4MT, 3]


@dataclasses.dataclass(frozen=True)
class SeqTemplate:
    """Static merged body+cloth template of the seq stage, index dtypes as
    in the JAX package. Every vertex lies in exactly one of ``body_vidx`` /
    ``cloth_vidx``."""

    v: torch.Tensor                # [Vt, 3] float32
    f: torch.Tensor                # [Ft, 3] int32
    v_labels: torch.Tensor         # [Vt] int32, 0 body / 1 cloth
    face_labels: torch.Tensor      # [Ft] int32
    body_vidx: torch.Tensor        # [Nb] int32
    cloth_vidx: torch.Tensor       # [Nc] int32
    body_f: torch.Tensor           # [Fb, 3] int32, ids into v
    connected_faces: torch.Tensor  # [P, 2] int32
    # skinning weights [Vt, J] transferred once at the rest template (the
    # stage driver's choice under stages.seq_static_skin_weights); None:
    # transferred at the deformed positions every step, as the reference
    # does
    w_pts: Optional[torch.Tensor] = None


class GeometryModel:
    def __init__(self, cfg: Config, grid: TetGrid, deformer: SMPLXDeformer,
                 canon: CanonicalState):
        self.cfg = cfg
        self.grid = grid
        self.deformer = deformer
        self.canon = canon
        f = cfg.field
        self.sdf_mlp = MLP(n_freq=f.n_freq, d_hidden=f.d_hidden,
                           n_hidden=f.n_hidden, skip_in=f.skip_in,
                           use_bfloat16=f.use_bfloat16, d_out=1)
        self.nonrigid = DeformMLP(n_freq=f.n_freq_deform, d_hidden=f.d_hidden,
                                  n_hidden=f.n_hidden, skip_in=f.skip_in,
                                  pose_dim=f.pose_code_dim, d_out=3,
                                  use_bfloat16=f.use_bfloat16)
        self.max_verts = cfg.geometry.max_verts
        self.max_tets = cfg.geometry.max_tets
        self.max_displacement = cfg.geometry.max_displacement

    def init_params(self, gen: torch.Generator, n_images: int) -> Params:
        """The JAX package's tree from ``gen``: sdf_net and both DeformMLPs
        (nn.Linear init), msdf ~ U - 0.01 clipped, deform = 0, cond and
        render_cond ~ U [n_images + 1, cond_dim], fix_code ~ 0.1 N
        [1, 1, pose_code_dim]."""
        dev = self.grid.verts.device
        N = self.grid.n_verts
        f = self.cfg.field
        sdf_net = self.sdf_mlp.init(gen, dev)
        msdf = torch.clamp(torch.rand((N,), generator=gen) - 0.01,
                           -1.0, 1.0).to(dev)
        return {"sdf_net": sdf_net, "msdf": msdf,
                "deform": torch.zeros((N, 3), device=dev),
                "nonrigid": self.nonrigid.init(gen, dev),
                "body_nonrigid": self.nonrigid.init(gen, dev),
                "cond": torch.rand((n_images + 1, f.cond_dim),
                                   generator=gen).to(dev),
                "render_cond": torch.rand((n_images + 1, f.cond_dim),
                                          generator=gen).to(dev),
                "fix_code": 0.1 * torch.randn((1, 1, f.pose_code_dim),
                                              generator=gen).to(dev)}

    def reinit_fields(self, gen: torch.Generator, params: Params) -> Params:
        """A new tree with msdf (~ U - 0.01, clipped) and sdf_net drawn
        anew from ``gen``, the rest shared (ref train.py:1802-1803)."""
        dev = self.grid.verts.device
        out = dict(params)
        out["msdf"] = torch.clamp(
            torch.rand((self.grid.n_verts,), generator=gen) - 0.01,
            -1.0, 1.0).to(dev)
        out["sdf_net"] = self.sdf_mlp.init(gen, dev)
        return out

    @staticmethod
    def clamp_params(params: Params) -> None:
        """Post-step clamps, in place (ref hmsdf.py:404-408)."""
        with torch.no_grad():
            params["deform"].clamp_(-1.0, 1.0)
            params["msdf"].clamp_(-2.0, 2.0)

    def query_sdf(self, params: Params, pts: torch.Tensor,
                  differentiated_once: bool = False) -> torch.Tensor:
        """The SDF MLP at pts [N, 3]; ``differentiated_once``: the caller
        never differentiates the SDF's gradient again (``MLP.apply``).
        Longer than ``geometry.sdf_chunk`` points, it runs chunk by chunk
        (zero-padded to whole chunks), each recomputed in the backward, so
        the backward's activations exist for one chunk at a time (the JAX
        package's ``jax.checkpoint`` under ``lax.map``); with grad on, the
        chunks take the MLP's unfused path, whose activations the
        checkpoint can drop."""
        chunk = self.cfg.geometry.sdf_chunk
        n = pts.shape[0] if pts.dim() == 2 else None

        def apply(p, checkpointed=False):
            return self.sdf_mlp.apply(
                params["sdf_net"], p, checkpointed=checkpointed,
                differentiated_once=differentiated_once)[..., 0]

        if not chunk or n is None or n <= chunk:
            return apply(pts)
        pts_p = torch.nn.functional.pad(pts, (0, 0, 0, (-n) % chunk))
        return torch.cat([
            torch.utils.checkpoint.checkpoint(apply, blk, True,
                                              use_reentrant=False)
            for blk in pts_p.split(chunk)])[:n]

    def deformed_grid(self, params: Params) -> torch.Tensor:
        return self.grid.verts + self.max_displacement * params["deform"]

    def extract(self, params: Params,
                msdf_sign: float = 1.0) -> Tuple[GShellMesh, torch.Tensor]:
        """The mesh of the SDF at the deformed grid, and that SDF [N]. The
        step differentiates it once, so the query may take the fused path
        with ``deform``'s gradient."""
        v_def = self.deformed_grid(params)
        sdf = self.query_sdf(params, v_def, differentiated_once=True)
        with span("d3h.geometry.extract"):
            mesh = gshell_extract(self.grid, v_def, sdf, params["msdf"],
                                  self.max_verts, self.max_tets,
                                  msdf_sign=msdf_sign)
        return mesh, sdf

    def pose_verts(self, verts: torch.Tensor,
                   pose_params: Dict[str, torch.Tensor], frame_idx: int,
                   w_pts: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.deformer.lbs_forward(self.canon, verts, pose_params,
                                         frame_idx, w_pts=w_pts)

    def get_meshes(self, params: Params, pose_params, frame_idx: int,
                   msdf_sign: float = 1.0) -> ExtractedMeshes:
        mesh, sdf = self.extract(params, msdf_sign)
        posed = self.pose_verts(mesh.verts, pose_params, frame_idx)
        posed = torch.where(mesh.vert_valid[:, None], posed,
                            torch.zeros((), device=posed.device))
        return ExtractedMeshes(mesh=mesh, sdf=sdf, verts_posed=posed,
                               verts_template=mesh.verts)

    def get_meshes_pair(self, params: Params, pose_params, frame_idx: int
                        ) -> Tuple[ExtractedMeshes, ExtractedMeshes]:
        """Both split-stage halves (cloth mSDF > 0, body mSDF < 0) over one
        SDF query, one level-1 extraction and ONE LBS pose of the shared
        vertex array; bit-identical to two ``get_meshes`` calls."""
        v_def = self.deformed_grid(params)
        sdf = self.query_sdf(params, v_def, differentiated_once=True)
        with span("d3h.geometry.extract"):
            cloth, body, raw = gshell_extract_pair(
                self.grid, v_def, sdf, params["msdf"], self.max_verts,
                self.max_tets)
        posed_raw = self.pose_verts(raw, pose_params, frame_idx)

        def pack(mesh):
            posed = torch.where(mesh.vert_valid[:, None], posed_raw,
                                torch.zeros((), device=posed_raw.device))
            return ExtractedMeshes(mesh=mesh, sdf=sdf, verts_posed=posed,
                                   verts_template=mesh.verts)

        return pack(cloth), pack(body)

    def seq_deformed(self, params: Params, template: SeqTemplate,
                     pose_params, frame_idx: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(posed [Vt, 3], delta [Vt, 3]): the nonrigid MLP's offsets of the
        cloth and the body vertices (both sets read ``nonrigid``, with
        ``fix_code``) on the template, then LBS (ref hmsdf.py:632-703); the
        range ``d3h.seq.deform`` under a profiler."""
        with span("d3h.seq.deform"):
            code = params["fix_code"]
            v = template.v
            cloth_idx = template.cloth_vidx.long()
            body_idx = template.body_vidx.long()
            cloth_delta = self.nonrigid.apply(params["nonrigid"],
                                              v[cloth_idx], code)
            body_delta = self.nonrigid.apply(params["nonrigid"], v[body_idx],
                                             code)
            delta = torch.zeros_like(v).index_copy(0, cloth_idx, cloth_delta) \
                .index_copy(0, body_idx, body_delta)
            posed = self.pose_verts(v + delta, pose_params, frame_idx,
                                    w_pts=template.w_pts)
            return posed, delta

    def static_skin_weights(self, verts: torch.Tensor) -> torch.Tensor:
        """Skinning weights [V, J] transferred once at ``verts`` (for
        stages.seq_static_skin_weights)."""
        return self.deformer.interpolate_weights(self.canon, verts)

    @staticmethod
    def _fit(net: Params, loss_fn, steps: int, lr: float
             ) -> Tuple[Params, float]:
        """Full-batch Adam on a copy of an MLP's layers: ``steps`` steps
        minimising ``loss_fn(layers)``. Returns the fitted layers and the
        last step's loss (taken before its update). Under a profiler, each
        step and its forward, backward and optimizer parts are ranges of
        the trace (``utils.logging.span``)."""
        with span("d3h.geometry.fit"):
            leaves = [t.detach().clone().requires_grad_(True)
                      for lay in net["layers"] for t in (lay["w"], lay["b"])]
            layers = {"layers": [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                                 for i in range(len(leaves) // 2)]}
            opt = torch.optim.Adam(leaves, lr=lr, eps=1e-8)
            loss = torch.zeros(())
            for _ in range(steps):
                with span("d3h.geometry.fit.step"):
                    opt.zero_grad(set_to_none=True)
                    with span("d3h.geometry.fit.forward"):
                        loss = loss_fn(layers)
                    with span("d3h.geometry.fit.backward"):
                        loss.backward()
                    with span("d3h.geometry.fit.optimizer"):
                        opt.step()
            return ({"layers": [{k: v.detach() for k, v in lay.items()}
                                for lay in layers["layers"]]},
                    float(loss.detach()))

    def pretrain_sdf(self, params: Params, target_sdf: torch.Tensor,
                     steps: int, lr: float = 1e-3) -> Tuple[Params, float]:
        """Fit sdf_net to target SDF values at the (undeformed) grid
        vertices with full-batch Adam (ref hmsdf.py:251-273). Returns the
        new params and the final loss."""
        tgt = target_sdf.reshape(-1)
        out = dict(params)
        out["sdf_net"], loss = self._fit(
            params["sdf_net"], lambda net: ((self.sdf_mlp.apply(
                net, self.grid.verts)[..., 0] - tgt) ** 2).mean(),
            steps, lr)
        return out, loss

    def pretrain_nonrigid_zero(self, params: Params, steps: int,
                               which: str = "nonrigid",
                               lr: float = 1e-3) -> Params:
        """Fit the DeformMLP ``which`` to output zeros at the grid vertices
        under a zero pose code, full-batch Adam (ref hmsdf.py:276-308)."""
        code = torch.zeros((1, 1, self.cfg.field.pose_code_dim),
                           device=self.grid.verts.device)
        out = dict(params)
        out[which], _ = self._fit(
            params[which], lambda net: (self.nonrigid.apply(
                net, self.grid.verts, code) ** 2).mean(), steps, lr)
        return out

    def smpl_template_sdf(self) -> torch.Tensor:
        """Signed distance [N] of the canonical template at the grid
        vertices, positive inside (ref hmsdf.py:236-237 negates pysdf): the
        tensor op ``mesh_sdf`` with K=8."""
        verts = self.canon.vs_template[0]
        faces = torch.as_tensor(np.asarray(self.deformer.model.faces),
                                dtype=torch.int64, device=verts.device)
        with torch.no_grad():
            return mesh_sdf(self.grid.verts, verts, faces, k=8,
                            sign_convention="pos_inside")


def collision_loss(cloth_pos: torch.Tensor, body_pos: torch.Tensor,
                   body_faces: torch.Tensor,
                   push_eps: float = 0.005) -> torch.Tensor:
    """Cloth-vs-body interpenetration hinge (ref hmsdf.py:98-132): each
    cloth point's nearest body face centre (blocked K=1 search), the signed
    distance along that face's normal, mean squared hinge on eps - d.

    As in the JAX package, ``body_faces`` index ``body_pos`` with ids
    clamped to its last row (a JAX gather clamps; the seq tick passes the
    template's ids into the body-vertex subset). The centre/normal gather's
    backward is the scatter kernel. The forward is the range
    ``d3h.seq.collision`` under a profiler."""
    with span("d3h.seq.collision"):
        faces = body_faces.long().clamp(0, body_pos.shape[0] - 1)
        tri = gather_rows(body_pos, faces)                    # [Fb, 3, 3]
        # the mean as XLA computes it: the sum times the reciprocal
        centers = (tri[:, 0] + tri[:, 1] + tri[:, 2]) * (1.0 / 3.0)
        n = mesh_ops.safe_normalize(torch.linalg.cross(
            tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1))
        _, idx = knn1(cloth_pos, centers)
        nn_cn = gather_rows(torch.cat([centers, n], dim=-1), idx)
        d = ((cloth_pos - nn_cn[:, :3]) * nn_cn[:, 3:]).sum(-1)
        inter = torch.relu(push_eps - d)
        return (inter * inter).mean()
