"""Minimal VTU (VTK XML unstructured grid) writer, no external dependencies
(port of homogenization_jl_tpu/utils/vtk.py; the files are byte for byte
the JAX writer's).

Rebuild of the reference's WriteVTK usage (src/utils.jl:11-19, exports in
src/examples/homogenized_coefficients.jl:71-87): triangle / tet meshes with
point data and cell data, for Paraview inspection of conductivity fields and
recurrence iterates. Host code; ``export_solution`` also takes a tensor and
copies only the columns it writes to the host.
"""

from __future__ import annotations

import base64
import struct

import numpy as np
import torch

from ..mesh.grid import Mesh, affine_maps

_VTK_TRIANGLE = 5
_VTK_TETRA = 10


def _b64(arr: np.ndarray) -> str:
    raw = arr.tobytes()
    header = struct.pack("<I", len(raw))
    return base64.b64encode(header + raw).decode("ascii")


def _data_array(name: str, arr: np.ndarray, n_components: int = 1) -> str:
    dtype_map = {
        np.dtype(np.float64): "Float64",
        np.dtype(np.float32): "Float32",
        np.dtype(np.int64): "Int64",
        np.dtype(np.int32): "Int32",
        np.dtype(np.uint8): "UInt8",
    }
    t = dtype_map[arr.dtype]
    comp = f' NumberOfComponents="{n_components}"' if n_components > 1 else ""
    return (
        f'<DataArray type="{t}" Name="{name}"{comp} format="binary">'
        f"{_b64(np.ascontiguousarray(arr))}</DataArray>"
    )


def write_vtu(
    filename: str,
    mesh: Mesh,
    point_data: dict | None = None,
    cell_data: dict | None = None,
) -> str:
    """Write the mesh (+ optional nodal / per-element fields) as a .vtu file.

    ``point_data[name]``: [Nn] or [Nn, k]; ``cell_data[name]``: [Ne] or
    [Ne, k]. Returns the filename written.
    """
    if not filename.endswith(".vtu"):
        filename += ".vtu"
    nn, ne = mesh.nnodes, mesh.nelements
    pts = np.zeros((nn, 3), dtype=np.float64)
    pts[:, : mesh.dim] = mesh.nodes
    conn = mesh.elements.astype(np.int64).reshape(-1)
    npe = mesh.nodes_per_element
    offsets = (np.arange(1, ne + 1, dtype=np.int64)) * npe
    ctype = _VTK_TRIANGLE if mesh.dim == 2 else _VTK_TETRA
    types = np.full(ne, ctype, dtype=np.uint8)

    def fields(data):
        out = []
        for name, arr in (data or {}).items():
            arr = np.asarray(arr)
            ncomp = 1 if arr.ndim == 1 else arr.shape[1]
            out.append(_data_array(name, arr, ncomp))
        return "\n".join(out)

    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
<UnstructuredGrid>
<Piece NumberOfPoints="{nn}" NumberOfCells="{ne}">
<Points>{_data_array("Points", pts, 3)}</Points>
<Cells>
{_data_array("connectivity", conn)}
{_data_array("offsets", offsets)}
{_data_array("types", types)}
</Cells>
<PointData>
{fields(point_data)}
</PointData>
<CellData>
{fields(cell_data)}
</CellData>
</Piece>
</UnstructuredGrid>
</VTKFile>
"""
    with open(filename, "w") as f:
        f.write(xml)
    return filename


def construct_full_grid(plan, level: int) -> Mesh:
    """Explode the implicit grid at `level` into a real mesh with interface
    nodes repeated (reference: construct_full_grid,
    src/implicit_fine_grid.jl:41-78). Node count = E * n_local — be careful.
    """
    base = plan.base
    ref_mesh = plan.reference.levels[level]
    J, shift, _, _ = affine_maps(base)
    nodes = (
        np.einsum("eij,nj->eni", J, ref_mesh.nodes) + shift[:, None, :]
    ).reshape(-1, base.dim)
    E = base.nelements
    offs = (np.arange(E, dtype=np.int64) * ref_mesh.nnodes)[:, None, None]
    elements = (ref_mesh.elements[None, :, :] + offs).reshape(
        -1, ref_mesh.nodes_per_element
    )
    return Mesh(nodes, elements)


def level_columns(plan, level: int, x):
    """The columns of a duplicated-layout state ``x`` [E, n_local(k)] that
    hold the level-``level`` nodes, [E, n_local(level)], in x's kind (a
    tensor stays on its device). The state's level k is the one whose
    node count is x.shape[1]."""
    ref = plan.reference
    k_x = next(k for k in range(ref.nlevels) if ref.levels[k].nnodes == x.shape[1])
    sel = ref.level_in_level(level, k_x)
    if isinstance(x, torch.Tensor):
        return x[:, torch.as_tensor(sel, device=x.device)]
    return np.asarray(x)[:, sel]


def export_solution(filename: str, plan, level: int, x) -> str:
    """Dump the duplicated-layout solution restricted to `level` on the
    exploded grid (reference: export_unknown, homogenized_coefficients.jl:
    81-87, which slices the coarse-prefix DOFs; here the level-in-finest node
    map handles arbitrary reference numberings). ``x`` may be a tensor:
    only the level's columns are copied to the host."""
    full = construct_full_grid(plan, level)
    vals = level_columns(plan, level, x)
    if isinstance(vals, torch.Tensor):
        vals = vals.cpu().numpy()
    return write_vtu(filename, full, point_data={"v": vals.reshape(-1)})


def export_conductivity(filename: str, base: Mesh, sigma_el: np.ndarray) -> str:
    """Dump the per-element conductivity on the base mesh (reference:
    export_domain, homogenized_coefficients.jl:71-79)."""
    return write_vtu(filename, base, cell_data={"a": np.asarray(sigma_el)})
