r"""Mesh overlay rendering (port of ``robustcap_tpu/viz/render.py``).

Rebuild of the reference's ``articulate/renderer.py`` (Renderer.render:37 —
pyrender offscreen + depth-mask composite). Two backends:

* ``SoftwareRenderer`` — a dependency-free numpy z-buffer rasterizer with a
  headlight Lambert shade, good enough for overlay videos and CI-testable
  (the JAX package's, line for line: the same images bit for bit),
* ``Renderer`` — uses pyrender when available (same API as the reference),
  falling back to the software path otherwise. Vertices may be numpy arrays
  or tensors on any device; they are copied to the host once a call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..smpl.model import ParametricModel, _host

__all__ = ["SoftwareRenderer", "Renderer"]


class SoftwareRenderer:
    r"""Pinhole z-buffer rasterizer (flat shading, backface-aware)."""

    def __init__(self, resolution: Tuple[int, int] = (1920, 1080)):
        self.width, self.height = resolution

    def render(self, image: Optional[np.ndarray], verts: np.ndarray,
               faces: np.ndarray, K: np.ndarray,
               mesh_color=(0.7, 0.7, 0.6, 1.0)) -> np.ndarray:
        r"""Composite the camera-frame mesh over ``image`` (or black).

        verts [V, 3] camera frame (+z forward), faces [F, 3], K [3, 3].
        """
        H, W = self.height, self.width
        if image is None:
            image = np.zeros((H, W, 3), np.uint8)
        out = image.copy()
        zbuf = np.full((H, W), np.inf, np.float32)

        v = np.asarray(verts, np.float32)
        f = np.asarray(faces, np.int64)
        z = v[:, 2]
        valid_v = z > 1e-4
        uvw = v @ np.asarray(K, np.float32).T
        uv = uvw[:, :2] / np.maximum(uvw[:, 2:], 1e-6)

        tri = f[valid_v[f].all(axis=1)]
        if len(tri) == 0:
            return out
        p = uv[tri]                    # [F, 3, 2]
        tz = z[tri]                    # [F, 3]
        # face normal for shading
        e1 = v[tri[:, 1]] - v[tri[:, 0]]
        e2 = v[tri[:, 2]] - v[tri[:, 0]]
        n = np.cross(e1, e2)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
        shade = np.clip(np.abs(n[:, 2]) * 0.8 + 0.2, 0, 1)
        base = np.asarray(mesh_color[:3], np.float32) * 255.0
        alpha = float(mesh_color[3]) if len(mesh_color) > 3 else 1.0

        # rasterize per face (vectorized inside the face bbox)
        order = np.argsort(-tz.mean(axis=1))   # far-to-near helps locality
        for fi in order:
            pts = p[fi]
            x0 = max(int(np.floor(pts[:, 0].min())), 0)
            x1 = min(int(np.ceil(pts[:, 0].max())) + 1, W)
            y0 = max(int(np.floor(pts[:, 1].min())), 0)
            y1 = min(int(np.ceil(pts[:, 1].max())) + 1, H)
            if x0 >= x1 or y0 >= y1:
                continue
            xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
            # barycentric coordinates
            d = ((pts[1, 1] - pts[2, 1]) * (pts[0, 0] - pts[2, 0])
                 + (pts[2, 0] - pts[1, 0]) * (pts[0, 1] - pts[2, 1]))
            if abs(d) < 1e-9:
                continue
            w0 = ((pts[1, 1] - pts[2, 1]) * (xs - pts[2, 0])
                  + (pts[2, 0] - pts[1, 0]) * (ys - pts[2, 1])) / d
            w1 = ((pts[2, 1] - pts[0, 1]) * (xs - pts[2, 0])
                  + (pts[0, 0] - pts[2, 0]) * (ys - pts[2, 1])) / d
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue
            zi = w0 * tz[fi, 0] + w1 * tz[fi, 1] + w2 * tz[fi, 2]
            sub = zbuf[y0:y1, x0:x1]
            closer = inside & (zi < sub)
            if not closer.any():
                continue
            sub[closer] = zi[closer]
            color = (shade[fi] * base).astype(np.float32)
            region = out[y0:y1, x0:x1].astype(np.float32)
            region[closer] = alpha * color + (1 - alpha) * region[closer]
            out[y0:y1, x0:x1] = region.astype(np.uint8)
        return out


class Renderer:
    r"""Mesh overlay renderer with the reference's API
    (articulate/renderer.py:14-87): pyrender when importable, otherwise the
    software rasterizer. Without ``model`` it builds a ``ParametricModel``
    on ``device`` (the card by default; pass ``device="cpu"`` on a host
    without one)."""

    def __init__(self, resolution=(1920, 1080), official_model_file=None,
                 model=None, device="cuda"):
        self.model = model or ParametricModel(official_model_file,
                                              device=device)
        self.resolution = resolution
        try:
            import pyrender
            import trimesh  # noqa: F401 - _render_pyrender needs it too
            # a *usable* pyrender, not a bare stub (test harnesses may
            # register placeholder modules for unrelated imports)
            if not hasattr(pyrender, "OffscreenRenderer"):
                raise ImportError("pyrender lacks OffscreenRenderer")
            self._backend = "pyrender"
        except ImportError:
            self._backend = "software"
        self._soft = SoftwareRenderer(resolution)

    def render(self, image, verts, K, mesh_color=(0.7, 0.7, 0.6, 1.0)):
        verts = _host(verts, np.float32).reshape(-1, 3)
        if self._backend == "pyrender":
            return self._render_pyrender(image, verts, K, mesh_color)
        return self._soft.render(image, verts, self.model.face,
                                 _host(K), mesh_color)

    def _render_pyrender(self, image, verts, K, mesh_color):
        import pyrender
        import trimesh
        scene = pyrender.Scene(ambient_light=[0.3, 0.3, 0.3])
        mesh = trimesh.Trimesh(vertices=verts, faces=self.model.face)
        mesh.visual.vertex_colors = np.tile(
            (np.asarray(mesh_color) * 255).astype(np.uint8), (len(verts), 1))
        scene.add(pyrender.Mesh.from_trimesh(mesh))
        K = np.asarray(K)
        cam = pyrender.IntrinsicsCamera(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
        pose = np.eye(4)
        pose[1, 1] = pose[2, 2] = -1  # OpenGL camera convention
        scene.add(cam, pose=pose)
        for d in ([1, 1, 1], [-1, 1, 1], [1, -1, 1]):
            light = pyrender.DirectionalLight(intensity=2.0)
            lp = np.eye(4)
            lp[:3, 3] = d
            scene.add(light, pose=lp)
        r = pyrender.OffscreenRenderer(*self.resolution)
        color, depth = r.render(scene)
        r.delete()
        if image is None:
            return color[..., :3]
        out = np.asarray(image).copy()
        mask = depth > 0
        out[mask] = color[..., :3][mask]
        return out
