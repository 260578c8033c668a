"""Live map visualization for headless deployments — a copy of
``coxgraph_tpu.eval.live_view`` over the port's server and mapper: the
reference's Open3D live windows (client combined-mesh view
coxgraph_client.h:177-214, server visualizer windows
server_visualizer.h:108-120) for a machine with no display server: the
"window" is a self-contained HTML viewer file the server rewrites on
every update and any browser auto-refreshes.

Zero dependencies: the viewer embeds its vertex data and a small canvas
renderer (painter-sorted point splats, drag to orbit, wheel to zoom) —
no three.js, no network access, works from file://.

    viewer = LiveMeshViewer("/tmp/coxgraph_live")
    ...
    viewer.update(verts, colors)            # per auto-mesh event
    viewer.update_from_server(server)       # convenience pull
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<meta charset="utf-8">
<meta http-equiv="refresh" content="{refresh}">
<title>coxgraph_tpu live map</title>
<style>body{{margin:0;background:#111;color:#ccc;font:12px monospace}}
#hud{{position:fixed;left:8px;top:8px}}</style>
<canvas id=c></canvas><div id=hud>{label} — {n} pts — drag=orbit wheel=zoom
(auto-refresh {refresh}s)</div>
<script>
const P={pts}, C={cols};
const cv=document.getElementById('c'),g=cv.getContext('2d');
let W,H;function rs(){{W=cv.width=innerWidth;H=cv.height=innerHeight;}}
rs();onresize=rs;
let yaw=0.7,pit=0.4,zoom={zoom},cx={cx},cy={cy},cz={cz};
let drag=0,lx=0,ly=0;
cv.onmousedown=e=>{{drag=1;lx=e.x;ly=e.y}};onmouseup=()=>drag=0;
onmousemove=e=>{{if(drag){{yaw+=(e.x-lx)*.01;pit+=(e.y-ly)*.01;
lx=e.x;ly=e.y;draw()}}}};
cv.onwheel=e=>{{zoom*=e.deltaY>0?0.9:1.1;draw();e.preventDefault()}};
function draw(){{
 g.fillStyle='#111';g.fillRect(0,0,W,H);
 const sy=Math.sin(yaw),cyw=Math.cos(yaw),sp=Math.sin(pit),cp=Math.cos(pit);
 const n=P.length/3,ord=new Array(n);
 const xs=new Float32Array(n),ys=new Float32Array(n),zs=new Float32Array(n);
 for(let i=0;i<n;i++){{
  const x=P[3*i]-cx,y=P[3*i+1]-cy,z=P[3*i+2]-cz;
  const x1=cyw*x+sy*y,y1=-sy*x+cyw*y;
  const y2=cp*y1+sp*z,z2=-sp*y1+cp*z;
  xs[i]=x1;ys[i]=z2;zs[i]=y2;ord[i]=i;}}
 ord.sort((a,b)=>zs[a]-zs[b]);
 const s=Math.min(W,H)*zoom;
 for(const i of ord){{
  g.fillStyle='rgb('+C[3*i]+','+C[3*i+1]+','+C[3*i+2]+')';
  g.fillRect(W/2+xs[i]*s,H/2-ys[i]*s,2,2);}}
}}
draw();
</script>
"""


class LiveMeshViewer:
    """Rewrites ``<dir>/live.html`` (plus ``live.json`` raw data) on each
    update — the push-rate counterpart of the periodic auto-mesh
    (generateGlobalMeshEvent, coxgraph_server.h:275-283)."""

    def __init__(self, out_dir: str, label: str = "global map",
                 max_points: int = 60_000, refresh_s: int = 2):
        self.out_dir = out_dir
        self.label = label
        self.max_points = max_points
        self.refresh_s = refresh_s
        self.n_updates = 0
        os.makedirs(out_dir, exist_ok=True)

    @property
    def html_path(self) -> str:
        return os.path.join(self.out_dir, "live.html")

    def update(self, verts: np.ndarray,
               colors: Optional[np.ndarray] = None) -> str:
        """verts (N,3) or triangle soup (T,3,3); colors uint8 (N,3)."""
        v = np.asarray(verts, np.float32).reshape(-1, 3)
        c = (np.asarray(colors, np.uint8).reshape(-1, 3)
             if colors is not None
             else np.full((v.shape[0], 3), 200, np.uint8))
        if v.shape[0] > self.max_points:
            step = v.shape[0] // self.max_points + 1
            v, c = v[::step], c[::step]
        center = v.mean(axis=0) if v.size else np.zeros(3)
        extent = float(np.abs(v - center).max()) if v.size else 1.0
        page = _PAGE.format(
            refresh=self.refresh_s, label=self.label, n=v.shape[0],
            pts=json.dumps(np.round(v, 3).reshape(-1).tolist()),
            cols=json.dumps(c.reshape(-1).tolist()),
            zoom=0.45 / max(extent, 1e-3),
            cx=round(float(center[0]), 3), cy=round(float(center[1]), 3),
            cz=round(float(center[2]), 3))
        tmp = self.html_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(page)
        os.replace(tmp, self.html_path)      # atomic: refresh never sees
        with open(os.path.join(self.out_dir, "live.json"), "w") as f:
            json.dump({"t": time.time(), "n_points": int(v.shape[0]),
                       "label": self.label, "update": self.n_updates}, f)
        self.n_updates += 1
        return self.html_path

    def update_from_mapper(self, mapper, **mesh_kwargs) -> str:
        """Render a client HostMapper's live map via the INCREMENTAL
        mesh path (HostMapper.live_mesh_odom): each update re-meshes only
        the blocks integrated since the previous one, so the per-update
        cost tracks changed geometry rather than map size (the
        reference's frame-rate submap mesh streaming,
        map_server.cpp:119-152). ``mesh_kwargs`` forward to the
        per-submap IncrementalMeshers — streaming missions should pass
        a real min_weight (e.g. 0.1): the 1e-4 default meshes every
        grazing observation (3-4× the triangles)."""
        verts, cols = mapper.live_mesh_odom(**mesh_kwargs)
        return self.update(
            verts.reshape(-1, 3),
            np.round(np.clip(cols.reshape(-1, 3), 0, 1) * 255
                     ).astype(np.uint8))

    def update_from_server(self, server, min_weight: float = 0.1) -> str:
        """Pull the combined client-pushed submap meshes (cheap — no
        re-optimization) and render them; falls back to the full final
        mesh when no client meshes were pushed yet."""
        verts, _, cols = server.combined_submap_mesh()
        if verts.shape[0] == 0:
            _, verts, cols = server.get_final_global_mesh(
                min_weight=min_weight)
            verts = np.asarray(verts).reshape(-1, 3)
            cols = np.asarray(cols).reshape(-1, 3)
        return self.update(verts, cols)
