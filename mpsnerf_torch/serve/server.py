"""HTTP front-end of a port bundle (port of
``mpsnerf_tpu/serve/server.py``, stdlib only), with the JAX server's wire
protocol and routes, so that a client of one works against the other:

    GET  /healthz          -> {"status": "ok", "backend": ..., ...}
    GET  /manifest         -> the bundle's manifest.json
    GET  /actors           -> {name: model class}
    POST /render?view=K    -> body: one ``.npz`` whose keys are
                              ``sp.<key>`` / ``tp.<key>`` item arrays
                              (nested dicts dotted: ``tp.params.poses``);
                              response: ``.npy`` bytes of the rendered
                              (H*W, 3) float32 view K.  Optional key
                              ``ray_mask`` renders only masked rays.
                              ``&global=0`` takes the chunked path;
                              ``&sharded=1`` is refused (400): the port
                              renders on one device.
    POST /camera?h=H&w=W   -> same body plus ``camera.K``, ``camera.R``,
                              ``camera.T``: renders that pinhole camera;
                              ``.npy`` (H*W, 3).
    POST /spiral?frames=N  -> N spiral cameras around the subject; ``.npy``
                              (N, H, W, 3); ``&h=``/``&w=`` override the
                              bundle's resolution; ``&format=video&fps=3``
                              returns an MJPG ``.avi`` (``eval/video.py``).
    POST /mesh?n=256       -> the subject's mesh in the tp pose; ``.npz``
                              with ``verts`` (V, 3) f32 and ``tris``
                              (T, 3); ``&threshold=`` sets the iso level.
    POST /animate?view=K   -> mesh-anchored animation of the tp pose;
                              ``.npy`` (H, W, 3); optional body keys
                              ``mesh.verts``/``mesh.tris`` give a canonical
                              mesh (else one is extracted at ``&n=``, 128);
                              ``&fast=1`` interpolates the baked rgb.

With several bundles, every route also answers under
``/actors/<name>/...``.  Device work is single-flighted inside
:class:`ServedRenderer`; the threaded server keeps request parsing and
response IO off the render path.  Run stand-alone::

    python -m mpsnerf_torch.serve.server --bundle /path/to/bundle --port 8080
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from mpsnerf_torch.serve.bundle import ServedRenderer, load_serving_bundle

__all__ = ["items_to_npz_bytes", "npz_bytes_to_items", "BundleServer",
           "main"]


def items_to_npz_bytes(sp_item: Dict, tp_item: Dict,
                       ray_mask: Optional[np.ndarray] = None,
                       camera: Optional[Dict] = None,
                       mesh: Optional[Dict] = None) -> bytes:
    """Client-side encoder: two item dicts -> one ``.npz`` request body.
    ``camera`` is a {"K", "R", "T"} dict for ``/camera``; ``mesh`` a
    {"verts", "tris"} dict giving ``/animate`` a canonical mesh.  Caches
    (``_`` keys) and attachments (named tuples) are not sent."""
    flat = {}
    for prefix, extra in (("camera", camera), ("mesh", mesh)):
        for k, v in (extra or {}).items():
            flat[f"{prefix}.{k}"] = np.asarray(v)
    for side, item in (("sp", sp_item), ("tp", tp_item)):
        for k, v in item.items():
            if k.startswith("_") or (isinstance(v, tuple)
                                     and hasattr(v, "_fields")):
                continue
            if isinstance(v, dict):
                for kk, vv in v.items():
                    flat[f"{side}.{k}.{kk}"] = np.asarray(vv)
            else:
                flat[f"{side}.{k}"] = np.asarray(v)
    if ray_mask is not None:
        flat["ray_mask"] = np.asarray(ray_mask)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def npz_bytes_to_items(
    body: bytes,
) -> Tuple[Dict, Dict, Optional[np.ndarray], Dict[str, np.ndarray],
           Dict[str, np.ndarray]]:
    """Server-side decoder: request body ->
    (sp_item, tp_item, ray_mask, camera, mesh)."""
    items: Dict[str, Dict] = {"sp": {}, "tp": {}, "camera": {}, "mesh": {}}
    ray_mask = None
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        for key in z.files:
            if key == "ray_mask":
                ray_mask = z[key]
                continue
            parts = key.split(".", 2)
            if len(parts) < 2 or parts[0] not in items:
                raise ValueError(f"bad request key {key!r}")
            side, name = parts[0], parts[1]
            if len(parts) == 3:
                items[side].setdefault(name, {})[parts[2]] = z[key]
            else:
                items[side][name] = z[key]
    return (items["sp"], items["tp"], ray_mask, items["camera"],
            items["mesh"])


def _counts(r: ServedRenderer) -> Dict:
    return {
        "model_class": r.manifest["model_class"],
        "chunk": r.chunk,
        "overflow_chunks": r.n_overflow_chunks,
        # JAX's field: the port's global path sizes its capacities from
        # the pre-passes' exact counts, so it never falls back
        "global_fallbacks": 0,
        "item_cache_hits": r.n_cache_hits,
        "has_global": r.manifest["has_global"],
    }


class BundleServer:
    """Threaded HTTP server over one bundle or a roster of them (a dict
    of actor name -> bundle, listed at ``GET /actors`` and served under
    ``/actors/<name>/...``; with one bundle the unprefixed routes serve
    it).  Bundles given as directories load on ``device``."""

    def __init__(self, bundle, host: str = "127.0.0.1", port: int = 0,
                 warmup: bool = False, device="cuda"):
        def _load(b):
            return (b if isinstance(b, ServedRenderer)
                    else load_serving_bundle(b, device=device))

        if isinstance(bundle, dict):
            self.renderers = {k: _load(v) for k, v in bundle.items()}
        else:
            self.renderers = {"default": _load(bundle)}
        # the target of the unprefixed routes when there is one bundle
        self.renderer = (next(iter(self.renderers.values()))
                         if len(self.renderers) == 1 else None)
        if warmup:
            for name, r in self.renderers.items():
                print(f"warmed {name}: {', '.join(r.warmup())}")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802
                pass  # errors surface as HTTP statuses

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj):
                self._send(code, json.dumps(obj).encode(),
                           "application/json")

            def _resolve(self, path):
                """path -> (renderer, route), honouring /actors/<name>/."""
                if path.startswith("/actors/"):
                    name, _, route = path[len("/actors/"):].partition("/")
                    if name not in outer.renderers:
                        raise KeyError(f"unknown actor {name!r} "
                                       f"(have {sorted(outer.renderers)})")
                    return outer.renderers[name], "/" + route
                if outer.renderer is None:
                    raise KeyError("multi-actor server: use /actors/<name>"
                                   f"{path} (have {sorted(outer.renderers)})")
                return outer.renderer, path

            def do_GET(self):  # noqa: N802
                path = urlparse(self.path).path
                if path == "/healthz":
                    first = next(iter(outer.renderers.values()))
                    self._json(200, {
                        "status": "ok",
                        "backend": first.device.type,
                        "actors": {name: _counts(r)
                                   for name, r in outer.renderers.items()},
                        **(_counts(outer.renderer)
                           if outer.renderer is not None else {}),
                    })
                    return
                if path == "/actors":
                    self._json(200, {name: r.manifest["model_class"]
                                     for name, r in outer.renderers.items()})
                    return
                try:
                    r, route = self._resolve(path)
                except KeyError as e:
                    self._json(404, {"error": str(e)})
                    return
                if route == "/manifest":
                    self._json(200, r.manifest)
                else:
                    self._json(404, {"error": f"no route {path!r}"})

            def do_POST(self):  # noqa: N802
                url = urlparse(self.path)
                # the whole body first: a refusal sent while the client is
                # still writing would reset its connection
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                try:
                    r, route = self._resolve(url.path)
                except KeyError as e:
                    self._json(404, {"error": str(e)})
                    return
                if route not in ("/render", "/camera", "/spiral", "/mesh",
                                 "/animate"):
                    self._json(404, {"error": f"no route {url.path!r}"})
                    return
                try:
                    q = parse_qs(url.query)

                    def arg(name, default):
                        return q.get(name, [default])[0]

                    sharded = bool(int(arg("sharded", "0")))
                    use_global = (bool(int(q["global"][0])) if "global" in q
                                  else None)
                    native = r.manifest["image_shape"][-2:]
                    sp, tp, mask, cam, mesh = npz_bytes_to_items(body)
                    if route == "/render":
                        out = r.render_view(sp, tp, int(arg("view", "0")),
                                            mask, sharded=sharded,
                                            use_global=use_global)
                    elif route == "/camera":
                        out = r.render_camera(
                            sp, tp, cam["K"], cam["R"], cam["T"],
                            int(arg("h", native[0])), int(arg("w", native[1])),
                            sharded=sharded, use_global=use_global)
                    elif route == "/animate":
                        out = r.animate(
                            sp, tp, view_index=int(arg("view", "0")),
                            height=int(arg("h", native[0])),
                            width=int(arg("w", native[1])),
                            can_verts=mesh.get("verts"),
                            tris=mesh.get("tris"),
                            mesh_n=int(arg("n", "128")),
                            fast=bool(int(arg("fast", "0"))))
                    elif route == "/mesh":
                        verts, tris = r.extract_mesh(
                            sp, tp, n=int(arg("n", "256")),
                            threshold=float(arg("threshold", "30.0")))
                        buf = io.BytesIO()
                        np.savez(buf, verts=verts, tris=tris)
                        self._send(200, buf.getvalue(),
                                   "application/octet-stream")
                        return
                    else:  # /spiral
                        hw = None
                        if "h" in q or "w" in q:
                            hw = (int(arg("h", native[0])),
                                  int(arg("w", native[1])))
                        out = r.render_spiral(
                            sp, tp, n_frames=int(arg("frames", "40")), hw=hw,
                            sharded=sharded, use_global=use_global)
                        if arg("format", "npy") == "video":
                            from mpsnerf_torch.eval.video import (
                                frames_to_video_bytes,
                            )

                            self._send(200, frames_to_video_bytes(
                                out, fps=int(arg("fps", "3"))),
                                "video/x-msvideo")
                            return
                except (ValueError, KeyError, IndexError) as e:
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                buf = io.BytesIO()
                np.save(buf, out)
                self._send(200, buf.getvalue(), "application/octet-stream")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> "BundleServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


def main(argv=None) -> None:
    import argparse
    import os

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bundle", required=True, action="append",
                   help="bundle directory, optionally 'name=dir'; repeat "
                        "for a multi-actor roster (/actors/<name>/...)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cpu for the CPU)")
    p.add_argument("--warmup", action="store_true",
                   help="render each bundle's sample view before accepting "
                        "requests (kernel builds, handles, pools)")
    args = p.parse_args(argv)
    if len(args.bundle) == 1 and "=" not in args.bundle[0]:
        bundles = args.bundle[0]
    else:
        bundles = {}
        for spec in args.bundle:
            name, eq, path = spec.partition("=")
            if not eq:
                name, path = os.path.basename(os.path.normpath(spec)), spec
            if name in bundles:
                raise SystemExit(f"duplicate actor name {name!r} "
                                 f"({bundles[name]!r} vs {path!r}): "
                                 "disambiguate with 'name=dir'")
            bundles[name] = path
    srv = BundleServer(bundles, args.host, args.port, warmup=args.warmup,
                       device=args.device)
    print(f"serving {args.bundle} on {srv.address[0]}:{srv.address[1]}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
