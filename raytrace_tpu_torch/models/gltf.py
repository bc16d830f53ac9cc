"""glTF 2.0 loader: what the reference extracts from a model file.

Port of `raytrace_tpu/models/gltf.py` (`TextureData` :37, `Primitive`
:46, `LoadedMesh` :64, `GltfFile` :107, `load_model` :268, `_read_tex`
:305, `_build_mesh` :332), itself the reference's builder/pr/model.rs:
recursive node walk with accumulated transforms, world-space positions,
local normals / tangents, triangle indices, base colour factor and
texture, normal map and scale, metallic-roughness factors and map. Each
texture decodes to f32 RGB in [0, 1] and, for integer images, keeps its
undivided u8 / u16 texels (`pixels_raw`), which decide the texel pool's
dtype (models/scene._TexPool).

Covers .gltf with embedded (data URI) or external buffers, .glb
containers, strided and sparse accessors. Images are decoded with PIL,
imported only where an image is decoded, so untextured models need no
PIL. Decodes are shared through the `image_cache` dict a caller passes
(keyed by file and image index), so N instances of one asset pool each
texture once.
"""
from __future__ import annotations

import base64
import io
import json
import os
import struct
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class TextureData:
    pixels: np.ndarray  # (H, W, 3) f32 in [0, 1]
    coords: np.ndarray  # (V, 2) f32 per-vertex uv
    pixels_raw: Optional[np.ndarray] = None  # (H, W, 3) u8 / u16 for integer images


@dataclass
class Primitive:
    """One glTF primitive (the reference's Mesh SoA entry)."""

    poses: np.ndarray  # (V, 3) world-space positions
    norms: np.ndarray  # (V, 3) local-space normals
    indices: np.ndarray  # (T, 3) int32
    rgb_factor: np.ndarray  # (3,)
    rgb_tex: Optional[TextureData] = None
    norm_scale: float = 1.0
    norm_tex: Optional[TextureData] = None
    tangents: Optional[np.ndarray] = None  # (V, 3) local
    metal_factor: float = 1.0
    rough_factor: float = 1.0
    mr_tex: Optional[TextureData] = None


@dataclass
class LoadedMesh:
    """One mesh node instance: its primitives and its world matrix."""

    primitives: list
    trans_mat: np.ndarray  # (4, 4) accumulated world transform


def _quat_to_mat(x, y, z, w):
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n > 0:
        x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], dtype=np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = m @ t
    if "rotation" in node:
        r = np.eye(4)
        r[:3, :3] = _quat_to_mat(*node["rotation"])
        m = m @ r
    if "scale" in node:
        s = np.eye(4)
        s[0, 0], s[1, 1], s[2, 2] = node["scale"]
        m = m @ s
    return m


class GltfFile:
    def __init__(self, path: str, image_cache: Optional[dict] = None):
        self.dir = os.path.dirname(os.path.abspath(path))
        self.path = os.path.abspath(path)
        self.image_cache = {} if image_cache is None else image_cache
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"glTF":
            self.doc, self.glb_bin = self._parse_glb(data)
        else:
            self.doc, self.glb_bin = json.loads(data.decode("utf-8")), None
        self.buffers = [self._load_buffer(b) for b in self.doc.get("buffers", [])]

    @staticmethod
    def _parse_glb(data: bytes):
        magic, version, _length = struct.unpack_from("<4sII", data, 0)
        if magic != b"glTF" or version != 2:
            raise ValueError("not a glTF 2.0 .glb container")
        off, doc, binchunk = 12, None, None
        while off < len(data):
            clen, ctype = struct.unpack_from("<II", data, off)
            chunk = data[off + 8: off + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(chunk.decode("utf-8"))
            elif ctype == 0x004E4942:  # BIN
                binchunk = chunk
            off += 8 + clen
        return doc, binchunk

    def _load_buffer(self, buf: dict) -> bytes:
        uri = buf.get("uri")
        if uri is None:
            if self.glb_bin is None:
                raise ValueError("glTF buffer with no uri outside a .glb")
            return self.glb_bin
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        p = os.path.join(self.dir, uri)
        if not os.path.exists(p):
            raise FileNotFoundError(f"glTF buffer {uri!r} missing next to {self.dir}")
        with open(p, "rb") as f:
            return f.read()

    def _view(self, view_idx: int, extra_offset: int = 0):
        bv = self.doc["bufferViews"][view_idx]
        return self.buffers[bv["buffer"]], bv.get("byteOffset", 0) + extra_offset, bv

    def accessor(self, idx: int) -> np.ndarray:
        acc = self.doc["accessors"][idx]
        count, ncomp = acc["count"], _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize * ncomp
        if "bufferView" not in acc:
            out = np.zeros((count, ncomp), dtype=dtype)
        else:
            data, start, bv = self._view(acc["bufferView"], acc.get("byteOffset", 0))
            stride = bv.get("byteStride") or itemsize
            if stride == itemsize:
                out = np.frombuffer(data, dtype=dtype, count=count * ncomp, offset=start)
                out = out.reshape(count, ncomp).copy()
            else:
                raw = np.frombuffer(data, dtype=np.uint8)
                rows = np.stack([raw[start + i * stride: start + i * stride + itemsize]
                                 for i in range(count)])
                out = rows.view(dtype).reshape(count, ncomp).copy()
        sp = acc.get("sparse")
        if sp:
            si, sv = sp["indices"], sp["values"]
            data, start, _ = self._view(si["bufferView"], si.get("byteOffset", 0))
            sidx = np.frombuffer(data, dtype=_COMPONENT_DTYPES[si["componentType"]],
                                 count=sp["count"], offset=start).astype(np.int64)
            data, start, _ = self._view(sv["bufferView"], sv.get("byteOffset", 0))
            out[sidx] = np.frombuffer(data, dtype=dtype, count=sp["count"] * ncomp,
                                      offset=start).reshape(sp["count"], ncomp)
        return out[:, 0] if acc["type"] == "SCALAR" else out

    def image(self, image_idx: int):
        """(f32 (H, W, 3) in [0, 1], raw u8/u16 (H, W, 3) or None): the
        reference's to_rgb32f (u8 / 255, u16 / 65535, luma replicated)."""
        key = (self.path, image_idx)
        if key in self.image_cache:
            return self.image_cache[key]
        from PIL import Image

        img = self.doc["images"][image_idx]
        if "uri" in img and not img["uri"].startswith("data:"):
            pil = Image.open(os.path.join(self.dir, img["uri"]))
        else:
            if "uri" in img:
                raw = base64.b64decode(img["uri"].split(",", 1)[1])
            else:
                data, s, bv = self._view(img["bufferView"])
                raw = data[s: s + bv["byteLength"]]
            pil = Image.open(io.BytesIO(raw))
        arr0 = np.asarray(pil)
        if arr0.ndim == 2:
            arr0 = np.repeat(arr0[:, :, None], 3, axis=2)
        arr0 = arr0[:, :, :3]
        raw3 = None
        if arr0.dtype == np.uint8:
            raw3 = np.ascontiguousarray(arr0)
            arr = arr0.astype(np.float32) / 255.0
        elif arr0.dtype == np.uint16:
            raw3 = np.ascontiguousarray(arr0)
            arr = arr0.astype(np.float32) / 65535.0
        else:
            arr = arr0.astype(np.float32)
        self.image_cache[key] = (arr, raw3)
        return arr, raw3


def load_model(path: str, translation, uniform_scale: float, euler_angles,
               image_cache: Optional[dict] = None) -> list:
    """The reference's model load (model.rs:19-53): root transform
    T(translation) @ S(uniform_scale) @ R(eulers), composed with each
    node's transform down the tree; one LoadedMesh per node with a mesh.
    Euler convention Rz(y) @ Ry(p) @ Rx(r)."""
    from .camera import euler_matrix

    g = GltfFile(path, image_cache)
    r, p, y = [float(v) for v in euler_angles]
    root = np.eye(4)
    root[:3, 3] = translation
    scale = np.eye(4)
    scale[0, 0] = scale[1, 1] = scale[2, 2] = uniform_scale
    rot = np.eye(4)
    rot[:3, :3] = euler_matrix(r, p, y)
    root = root @ scale @ rot

    doc = g.doc
    scenes = doc.get("scenes", [{"nodes": list(range(len(doc.get("nodes", []))))}])
    scene = scenes[doc.get("scene", 0)] if scenes else {"nodes": []}
    meshes: list = []
    stack = [(n, root) for n in reversed(scene.get("nodes", []))]
    while stack:  # depth-first, children in order: the JAX loader's walk
        node_idx, parent = stack.pop()
        node = doc["nodes"][node_idx]
        mat = parent @ _node_matrix(node)
        if "mesh" in node:
            meshes.append(_build_mesh(g, doc["meshes"][node["mesh"]], mat))
        stack.extend((c, mat) for c in reversed(node.get("children", [])))
    return meshes


def _read_tex(g: GltfFile, tex_info: Optional[dict], attrs: dict) -> Optional[TextureData]:
    if tex_info is None:
        return None
    attr = f"TEXCOORD_{tex_info.get('texCoord', 0)}"
    if attr not in attrs:
        return None
    coords = g.accessor(attrs[attr]).astype(np.float32)
    image_idx = g.doc["textures"][tex_info["index"]]["source"]
    try:
        pixels, raw = g.image(image_idx)
    except FileNotFoundError as e:
        # asset snapshots can lack texture files: factors only, as JAX does
        warnings.warn(f"texture missing, using factors only: {e}")
        return None
    return TextureData(pixels=pixels, coords=coords[:, :2], pixels_raw=raw)


def _build_mesh(g: GltfFile, mesh: dict, trans_mat: np.ndarray) -> LoadedMesh:
    prims = []
    for prim in mesh.get("primitives", []):
        if prim.get("mode", 4) != 4:  # triangles only, like the reference
            continue
        attrs = prim["attributes"]
        poses_local = g.accessor(attrs["POSITION"]).astype(np.float64)
        ones = np.ones((poses_local.shape[0], 1))
        world = (np.concatenate([poses_local, ones], axis=1) @ trans_mat.T)[:, :3]
        if "NORMAL" in attrs:
            norms = g.accessor(attrs["NORMAL"]).astype(np.float32)
        else:
            norms = np.zeros_like(world, dtype=np.float32)
            norms[:, 2] = 1.0
        if "indices" in prim:
            idx = g.accessor(prim["indices"]).astype(np.int64)
        else:
            idx = np.arange(poses_local.shape[0], dtype=np.int64)

        mat = (g.doc.get("materials") or [{}])[prim["material"]] if "material" in prim else {}
        pbr = mat.get("pbrMetallicRoughness", {})
        nrm = mat.get("normalTexture")
        tangents = None
        if "TANGENT" in attrs:
            tangents = g.accessor(attrs["TANGENT"]).astype(np.float32)[:, :3]
        prims.append(Primitive(
            poses=world.astype(np.float32),
            norms=norms,
            indices=idx.reshape(-1, 3).astype(np.int32),
            rgb_factor=np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)[:3],
            rgb_tex=_read_tex(g, pbr.get("baseColorTexture"), attrs),
            norm_scale=float(nrm.get("scale", 1.0)) if nrm else 1.0,
            norm_tex=_read_tex(g, nrm, attrs) if nrm else None,
            tangents=tangents,
            metal_factor=float(pbr.get("metallicFactor", 1.0)),
            rough_factor=float(pbr.get("roughnessFactor", 1.0)),
            mr_tex=_read_tex(g, pbr.get("metallicRoughnessTexture"), attrs),
        ))
    return LoadedMesh(primitives=prims, trans_mat=trans_mat.astype(np.float32))
