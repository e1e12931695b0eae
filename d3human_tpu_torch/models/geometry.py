"""The implicit human model of the init and split stages: SDF MLP + mSDF
G-Shell geometry posed by SMPL-X LBS (counterpart of the init- and
split-path part of ``d3human_tpu/models/geometry.py:GeometryModel``).

Parameters are a dict of tensors: ``sdf_net`` (MLP layers), ``msdf`` and
``deform`` per lattice vertex. Other geometry leaves converted from a JAX
tree (``nonrigid``, ``body_nonrigid``, ``cond``, ``render_cond``,
``fix_code``) ride along unread: neither step reads them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from d3human_tpu_torch.config import Config
from d3human_tpu_torch.models.fields import MLP
from d3human_tpu_torch.models.smplx.deformer import (
    CanonicalState, SMPLXDeformer,
)
from d3human_tpu_torch.ops.marching_tets import (
    GShellMesh, gshell_extract, gshell_extract_pair,
)
from d3human_tpu_torch.ops.tet_grid import TetGrid

Params = dict


class ExtractedMeshes(NamedTuple):
    mesh: GShellMesh
    sdf: torch.Tensor             # [N] field values on the deformed grid
    verts_posed: torch.Tensor     # [MV+4MT, 3]
    verts_template: torch.Tensor  # [MV+4MT, 3]


class GeometryModel:
    def __init__(self, cfg: Config, grid: TetGrid, deformer: SMPLXDeformer,
                 canon: CanonicalState):
        if cfg.geometry.sdf_chunk:
            raise NotImplementedError(
                "geometry.sdf_chunk > 0: the port evaluates the SDF MLP "
                "unchunked")
        self.cfg = cfg
        self.grid = grid
        self.deformer = deformer
        self.canon = canon
        f = cfg.field
        self.sdf_mlp = MLP(n_freq=f.n_freq, d_hidden=f.d_hidden,
                           n_hidden=f.n_hidden, skip_in=f.skip_in, d_out=1)
        self.max_verts = cfg.geometry.max_verts
        self.max_tets = cfg.geometry.max_tets
        self.max_displacement = cfg.geometry.max_displacement

    def init_params(self, gen: torch.Generator) -> Params:
        """sdf_net (nn.Linear init), msdf ~ U - 0.01 clipped, deform = 0."""
        dev = self.grid.verts.device
        N = self.grid.n_verts
        sdf_net = self.sdf_mlp.init(gen, dev)
        msdf = torch.clamp(torch.rand((N,), generator=gen) - 0.01,
                           -1.0, 1.0).to(dev)
        return {"sdf_net": sdf_net, "msdf": msdf,
                "deform": torch.zeros((N, 3), device=dev)}

    @staticmethod
    def clamp_params(params: Params) -> None:
        """Post-step clamps, in place (ref hmsdf.py:404-408)."""
        with torch.no_grad():
            params["deform"].clamp_(-1.0, 1.0)
            params["msdf"].clamp_(-2.0, 2.0)

    def query_sdf(self, params: Params, pts: torch.Tensor) -> torch.Tensor:
        return self.sdf_mlp.apply(params["sdf_net"], pts)[..., 0]

    def deformed_grid(self, params: Params) -> torch.Tensor:
        return self.grid.verts + self.max_displacement * params["deform"]

    def extract(self, params: Params,
                msdf_sign: float = 1.0) -> Tuple[GShellMesh, torch.Tensor]:
        v_def = self.deformed_grid(params)
        sdf = self.query_sdf(params, v_def)
        mesh = gshell_extract(self.grid, v_def, sdf, params["msdf"],
                              self.max_verts, self.max_tets,
                              msdf_sign=msdf_sign)
        return mesh, sdf

    def pose_verts(self, verts: torch.Tensor,
                   pose_params: Dict[str, torch.Tensor],
                   frame_idx: int) -> torch.Tensor:
        return self.deformer.lbs_forward(self.canon, verts, pose_params,
                                         frame_idx)

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
        sdf = self.query_sdf(params, v_def)
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

    def pretrain_sdf(self, params: Params, target_sdf: torch.Tensor,
                     steps: int, lr: float = 1e-3) -> Tuple[Params, float]:
        """Fit sdf_net to target SDF values at the (undeformed) grid
        vertices with full-batch Adam (ref hmsdf.py:251-273). Returns the
        new params and the final loss."""
        net = [t.detach().clone().requires_grad_(True)
               for lay in params["sdf_net"]["layers"] for t in (lay["w"],
                                                               lay["b"])]
        layers = [{"w": net[2 * i], "b": net[2 * i + 1]}
                  for i in range(len(net) // 2)]
        opt = torch.optim.Adam(net, lr=lr, eps=1e-8)
        tgt = target_sdf.reshape(-1)
        loss = torch.zeros(())
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            out = self.sdf_mlp.apply({"layers": layers}, self.grid.verts)
            loss = ((out[..., 0] - tgt) ** 2).mean()
            loss.backward()
            opt.step()
        out = dict(params)
        out["sdf_net"] = {"layers": [{k: v.detach() for k, v in lay.items()}
                                     for lay in layers]}
        return out, float(loss.detach())
