import numpy as np

from clive2.load import (
    load_obj,
    parse_obj,
    parse_ply,
    smooth_vertex_normals,
    soup_from_mesh,
)

CUBE_VERTS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.float64,
)
CUBE_QUADS = [
    (0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
    (2, 3, 7, 6), (1, 2, 6, 5), (0, 4, 7, 3),
]


def write_cube_obj(path):
    with open(path, "w") as f:
        for v in CUBE_VERTS:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for q in CUBE_QUADS:
            f.write("f " + " ".join(str(i + 1) for i in q) + "\n")


def test_parse_obj_quads(tmp_path):
    p = tmp_path / "cube.obj"
    write_cube_obj(p)
    verts, faces = parse_obj(str(p))
    assert verts.shape == (8, 3)
    assert faces.shape == (12, 3)  # 6 quads fan-triangulated


def test_parse_obj_slash_syntax(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1/1/1 2/2/2 3/3/3\n")
    verts, faces = parse_obj(str(p))
    assert faces.tolist() == [[0, 1, 2]]


def test_parse_ply_ascii(tmp_path):
    p = tmp_path / "tri.ply"
    p.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element face 2\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0\n1 0 0\n1 1 0\n0 1 0\n"
        "3 0 1 2\n3 0 2 3\n"
    )
    verts, faces = parse_ply(str(p))
    assert verts.shape == (4, 3)
    assert faces.tolist() == [[0, 1, 2], [0, 2, 3]]


def test_parse_ply_binary(tmp_path):
    import struct

    p = tmp_path / "tri_bin.ply"
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        "element vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element face 1\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    ).encode()
    body = b"".join(
        struct.pack("<3f", *v) for v in [(0, 0, 0), (1, 0, 0), (0, 1, 0)]
    ) + struct.pack("<B3i", 3, 0, 1, 2)
    p.write_bytes(header + body)
    verts, faces = parse_ply(str(p))
    np.testing.assert_allclose(verts, [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    assert faces.tolist() == [[0, 1, 2]]


def test_smooth_normals_flat_plane():
    # two coplanar triangles: smoothed vertex normals == face normal
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=np.float64)
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    fn = np.array([[0, 0, 1.0], [0, 0, 1.0]])
    vn = smooth_vertex_normals(verts, faces, fn)
    np.testing.assert_allclose(vn, np.tile([0, 0, 1.0], (4, 1)), atol=1e-12)


def test_smooth_normals_cube_corner():
    # cube corner vertex: smoothed normal points along the diagonal
    soup = soup_from_mesh(
        CUBE_VERTS,
        np.array([(q[0], q[1], q[2]) for q in CUBE_QUADS]
                 + [(q[0], q[2], q[3]) for q in CUBE_QUADS]),
    )
    assert len(soup) == 12
    # all face normals unit length
    np.testing.assert_allclose(
        np.linalg.norm(soup.face_normals, axis=1), 1.0, atol=1e-6
    )


def test_load_obj_scale_offset(tmp_path):
    p = tmp_path / "cube.obj"
    write_cube_obj(p)
    soup = load_obj(str(p), material=5, scale=2.0, offset=np.array([1, 0, 0]))
    assert soup.vertices[..., 0].min() >= 0.99
    assert soup.vertices[..., 0].max() <= 3.01
    assert soup.vertices[..., 1:].min() >= -0.01
    assert soup.vertices[..., 1:].max() <= 2.01
    assert (soup.material == 5).all()
    assert not soup.is_light.any()
