"""Debug/visualization exports: local map clouds, voxel-grid wireframes.

Covers the reference's debug-topic surface (frame/keypoints/local_map clouds
and the voxel_grid LINE_LIST marker, LidarOdometryServer.cpp:240-263 +
RosUtils.cpp:65-135) as file exports: PLY point clouds and a voxel-grid
line-segment set, loadable in any 3D viewer.
"""

from __future__ import annotations

import numpy as np


def write_ply(path, points, color=None):
    """ASCII PLY point cloud; ``color`` optional (r, g, b) 0-255."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if color is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for p in points:
            line = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if color is not None:
                line += f" {color[0]} {color[1]} {color[2]}"
            f.write(line + "\n")


# The 12 edges of a unit cube as index pairs into its 8 corners.
_CUBE_CORNERS = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                          for z in (0, 1)], np.float64)
_CUBE_EDGES = np.array([
    [0, 1], [0, 2], [0, 4], [1, 3], [1, 5], [2, 3], [2, 6], [3, 7],
    [4, 5], [4, 6], [5, 7], [6, 7]])


def voxel_grid_segments(voxel_coords, voxel_size: float):
    """Occupied voxels -> (S, 2, 3) wireframe line segments
    (VoxelsToMarker LINE_LIST parity, RosUtils.cpp:65-135)."""
    coords = np.asarray(voxel_coords, np.float64).reshape(-1, 3)
    corners = (coords[:, None, :] + _CUBE_CORNERS[None]) * voxel_size
    segs = corners[:, _CUBE_EDGES, :]          # (V, 12, 2, 3)
    return segs.reshape(-1, 2, 3)


def write_voxel_grid_ply(path, voxel_coords, voxel_size: float):
    """Voxel wireframe as a PLY edge mesh."""
    segs = voxel_grid_segments(voxel_coords, voxel_size)
    verts = segs.reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {len(segs)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n")
        for i in range(len(segs)):
            f.write(f"{2 * i} {2 * i + 1}\n")


def export_map_debug(server, out_prefix: str):
    """Dump the server's local map cloud + voxel grid (debug topics analog).

    Reads the port's table layout (``ops/hashmap.py``): (NB, G*R) int32
    bits, R = K + 4 lanes a slot, lane K the fingerprint (0 = empty), lanes
    K+1..K+3 the voxel key as int32."""
    cloud = server.local_map_pointcloud()  # settles any in-flight frames
    write_ply(out_prefix + "_local_map.ply", cloud, color=(120, 180, 255))
    m = server.state.map
    k = m.block_size
    tab = m.table.cpu().numpy().reshape(m.capacity, k + 4)
    occ = tab[:, k] != 0
    write_voxel_grid_ply(out_prefix + "_voxel_grid.ply", tab[occ, k + 1:k + 4],
                         server.config.voxel_size)
