"""Minimal VTU writer for solution visualisation (``--paraview``).

Replaces the reference's ParaView output path
(alfi/driver.py:106-107,121-122): writes the P1 part of the velocity
field and the cellwise pressure on the simplicial mesh as ASCII XML
UnstructuredGrid, loadable by ParaView.  Host numpy only: the caller
passes the state as arrays."""

from __future__ import annotations

import numpy as np

_VTK_CELL = {2: 5, 3: 10}  # triangle, tet


def write_vtu(path, mesh, Z, z):
    u = np.asarray(z[0])
    p = np.asarray(z[1])[Z.Q.cell_dofs[:, 0]]
    _write(path, mesh, u, p)


def write_velocity_vtu(path, mesh, u):
    """Velocity-only file (for visprolong-refined fields)."""
    _write(path, mesh, np.asarray(u), np.zeros(mesh.num_cells))


def _write(path, mesh, u, pc):
    d = mesh.dim
    nv = mesh.num_vertices
    # vertex dofs of the velocity space are ordered first (spaces.py)
    uvert = u[:nv]
    if d == 2:
        uvert = np.concatenate([uvert, np.zeros((nv, 1))], axis=1)
    pts = mesh.vertices
    if d == 2:
        pts = np.concatenate([pts, np.zeros((nv, 1))], axis=1)
    cells = mesh.cells
    nc = mesh.num_cells
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1">\n')
        f.write("<UnstructuredGrid>\n")
        f.write('<Piece NumberOfPoints="%d" NumberOfCells="%d">\n'
                % (nv, nc))
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        np.savetxt(f, pts, fmt="%.10g")
        f.write("</DataArray></Points>\n")
        f.write("<Cells>\n")
        f.write('<DataArray type="Int32" Name="connectivity" format="ascii">\n')
        np.savetxt(f, cells, fmt="%d")
        f.write("</DataArray>\n")
        f.write('<DataArray type="Int32" Name="offsets" format="ascii">\n')
        np.savetxt(f, (np.arange(nc) + 1) * (d + 1), fmt="%d")
        f.write("</DataArray>\n")
        f.write('<DataArray type="UInt8" Name="types" format="ascii">\n')
        np.savetxt(f, np.full(nc, _VTK_CELL[d]), fmt="%d")
        f.write("</DataArray>\n</Cells>\n")
        f.write('<PointData Vectors="Velocity">\n')
        f.write('<DataArray type="Float64" Name="Velocity" '
                'NumberOfComponents="3" format="ascii">\n')
        np.savetxt(f, uvert, fmt="%.10g")
        f.write("</DataArray>\n</PointData>\n")
        f.write('<CellData Scalars="Pressure">\n')
        f.write('<DataArray type="Float64" Name="Pressure" format="ascii">\n')
        np.savetxt(f, pc, fmt="%.10g")
        f.write("</DataArray>\n</CellData>\n")
        f.write("</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
