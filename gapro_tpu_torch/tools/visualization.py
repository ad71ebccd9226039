"""Scenes and their predictions as coloured point clouds: PLY files any
viewer opens, or one self-contained interactive HTML page (the port of
``tools/visualization.py``; the reference's open3d / pyviz3d viewers need a
display).

    python -m gapro_tpu_torch.tools.visualization --synthetic 1 --task instance_gt --out vis/
    python -m gapro_tpu_torch.tools.visualization --data_root dataset/scannetv2 \\
        --scene scene0011_00 --task instance_pred --prediction_path preds/ --out vis/

``--task``: ``input_rgb``, ``semantic_gt``, ``instance_gt`` and
``superpoint`` colour the scene's own data; ``instance_pred`` reads the
benchmark export of ``tools/test.py --out`` (each mask at or above
``--conf_thresh`` one colour); ``semantic_pred``, ``offset_semantic_pred``
and ``offset_vertices_pred`` read the ``.npy`` directories of
``tools/test.py --save_pointwise`` (the reference viewers'
``prediction_path`` layout). ``--format ply|html``. A scene is
``--synthetic N`` (``make_synthetic_scene(seed=N - 1)``) or
``<data_root>/val/<scene>_inst_nostuff.pth`` with
``<data_root>/superpoints/<scene>.pth``. The files are the JAX tool's,
byte for byte.
"""

from __future__ import annotations

import argparse
import base64
import itertools
import os
import os.path as osp

import numpy as np

TASKS = ("input_rgb", "semantic_gt", "instance_gt", "instance_pred", "superpoint",
         "semantic_pred", "offset_semantic_pred", "offset_vertices_pred")

# fixed 20-colour palette (ScanNet's)
PALETTE = np.array([
    [174, 199, 232], [152, 223, 138], [31, 119, 180], [255, 187, 120],
    [188, 189, 34], [140, 86, 75], [255, 152, 150], [214, 39, 40],
    [197, 176, 213], [148, 103, 189], [196, 156, 148], [23, 190, 207],
    [247, 182, 210], [219, 219, 141], [255, 127, 14], [158, 218, 229],
    [44, 160, 44], [112, 128, 144], [227, 119, 194], [82, 84, 163],
], np.uint8)

_PLY_HEADER = ("ply\nformat ascii 1.0\nelement vertex {n}\n"
               "property float x\nproperty float y\nproperty float z\n"
               "property uchar red\nproperty uchar green\nproperty uchar blue\n"
               "end_header\n")


def write_ply(path, xyz, rgb):
    """ASCII PLY of the points ``xyz`` [N, 3] coloured ``rgb`` (uint8
    [N, 3]), each coordinate with 4 decimals. The rows are formatted in
    one ``%`` over all of them, not one call a point."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    xyz, rgb = np.asarray(xyz), np.asarray(rgb)
    values = tuple(itertools.chain.from_iterable(map(list.__add__, xyz.tolist(), rgb.tolist())))
    with open(path, "w", encoding="utf-8") as f:
        f.write(_PLY_HEADER.format(n=len(xyz)))
        f.write(("%.4f %.4f %.4f %d %d %d\n" * len(xyz)) % values)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>html,body{{margin:0;height:100%;overflow:hidden;background:#111}}
canvas{{width:100%;height:100%;display:block}}
#hud{{position:fixed;top:8px;left:8px;color:#ddd;font:12px monospace}}</style>
</head><body><div id="hud">{title} — {npts} pts — drag: orbit, wheel: zoom,
shift-drag: pan</div><canvas id="c"></canvas>
<script>
// self-contained WebGL2 point-cloud viewer (no external libs — the repo
// machine is zero-egress and the reference's open3d/pyviz3d need a display)
const XYZ = Float32Array.from(atob("{xyz_b64}"), c=>c.charCodeAt(0));
const xyz = new Float32Array(XYZ.buffer);
const rgbBytes = Uint8Array.from(atob("{rgb_b64}"), c=>c.charCodeAt(0));
const n = rgbBytes.length/3;
const cv = document.getElementById("c");
const gl = cv.getContext("webgl2");
const vs = `#version 300 es
in vec3 p; in vec3 col; uniform mat4 mvp; out vec3 vc;
void main(){{ gl_Position = mvp*vec4(p,1.0); gl_PointSize = 2.0; vc = col; }}`;
const fs = `#version 300 es
precision mediump float; in vec3 vc; out vec4 o;
void main(){{ o = vec4(vc,1.0); }}`;
function sh(t,s){{const x=gl.createShader(t);gl.shaderSource(x,s);gl.compileShader(x);
if(!gl.getShaderParameter(x,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(x);return x;}}
const pr = gl.createProgram();
gl.attachShader(pr,sh(gl.VERTEX_SHADER,vs));gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(pr);gl.useProgram(pr);
function buf(data,loc,size,type,norm){{const b=gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER,b);gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);
gl.enableVertexAttribArray(loc);gl.vertexAttribPointer(loc,size,type,norm,0,0);}}
buf(xyz,gl.getAttribLocation(pr,"p"),3,gl.FLOAT,false);
buf(rgbBytes,gl.getAttribLocation(pr,"col"),3,gl.UNSIGNED_BYTE,true);
// center/scale
let cx=0,cy=0,cz=0;for(let i=0;i<n;i++){{cx+=xyz[3*i];cy+=xyz[3*i+1];cz+=xyz[3*i+2];}}
cx/=n;cy/=n;cz/=n;
let r=0;for(let i=0;i<n;i++){{const dx=xyz[3*i]-cx,dy=xyz[3*i+1]-cy,dz=xyz[3*i+2]-cz;
r=Math.max(r,dx*dx+dy*dy+dz*dz);}} r=Math.sqrt(r);
let az=0.6, el=0.5, dist=2.5*r, panX=0, panY=0;
function mat(){{
const a=Math.cos(az),b=Math.sin(az),c=Math.cos(el),d=Math.sin(el);
const ex=cx+dist*c*b, ey=cy-dist*c*a, ez=cz+dist*d;
// lookAt
let zx=ex-cx,zy=ey-cy,zz=ez-cz;const zl=Math.hypot(zx,zy,zz);zx/=zl;zy/=zl;zz/=zl;
let xx=zy*1-zz*0, xy=zz*0-zx*1, xz=zx*0-zy*0; // up=(0,0,1) cross
let xl=Math.hypot(xx,xy,xz);xx/=xl;xy/=xl;xz/=xl;
const yx=zy*xz-zz*xy, yy=zz*xx-zx*xz, yz=zx*xy-zy*xx;
const tx=-(xx*ex+xy*ey+xz*ez)+panX, ty=-(yx*ex+yy*ey+yz*ez)+panY,
      tz=-(zx*ex+zy*ey+zz*ez);
const f=1.0/Math.tan(0.4), asp=cv.width/cv.height, near=0.01*r, far=100*r;
const p00=f/asp, p11=f, p22=(far+near)/(near-far), p23=2*far*near/(near-far);
return new Float32Array([
 p00*xx, p11*yx, p22*zx, -zx,
 p00*xy, p11*yy, p22*zy, -zy,
 p00*xz, p11*yz, p22*zz, -zz,
 p00*tx, p11*ty, p22*tz+p23, -tz]);
}}
const mvpLoc = gl.getUniformLocation(pr,"mvp");
function draw(){{
cv.width=cv.clientWidth*devicePixelRatio;cv.height=cv.clientHeight*devicePixelRatio;
gl.viewport(0,0,cv.width,cv.height);gl.enable(gl.DEPTH_TEST);
gl.clearColor(0.07,0.07,0.07,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
gl.uniformMatrix4fv(mvpLoc,false,mat());gl.drawArrays(gl.POINTS,0,n);}}
let drag=false,px=0,py=0,pan=false;
cv.onmousedown=e=>{{drag=true;pan=e.shiftKey;px=e.clientX;py=e.clientY;}};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{{if(!drag)return;const dx=e.clientX-px,dy=e.clientY-py;
px=e.clientX;py=e.clientY;
if(pan){{panX+=dx*0.002*r;panY-=dy*0.002*r;}}else{{az+=dx*0.01;
el=Math.max(-1.5,Math.min(1.5,el+dy*0.01));}}draw();}};
cv.onwheel=e=>{{e.preventDefault();dist*=Math.exp(e.deltaY*0.001);draw();}};
window.onresize=draw; draw();
</script></body></html>
"""


def write_html(path, xyz, rgb, title="scene"):
    """One self-contained WebGL page of the points (no library, no network)."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    xyz = np.ascontiguousarray(np.asarray(xyz, np.float32))
    rgb = np.ascontiguousarray(np.asarray(rgb, np.uint8))
    html = _HTML_TEMPLATE.format(title=title, npts=len(xyz),
                                 xyz_b64=base64.b64encode(xyz.tobytes()).decode(),
                                 rgb_b64=base64.b64encode(rgb.tobytes()).decode())
    with open(path, "w", encoding="utf-8") as f:
        f.write(html)


def _box_edge_points(mn, mx, per_edge=24):
    """An axis-aligned box's 12 edges as ``per_edge`` points each (PLY and
    the page carry points only)."""
    t = np.linspace(0.0, 1.0, per_edge, dtype=np.float32)[:, None]
    corners = np.array([[mn[0], mn[1], mn[2]], [mx[0], mn[1], mn[2]],
                        [mn[0], mx[1], mn[2]], [mx[0], mx[1], mn[2]],
                        [mn[0], mn[1], mx[2]], [mx[0], mn[1], mx[2]],
                        [mn[0], mx[1], mx[2]], [mx[0], mx[1], mx[2]]], np.float32)
    edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    return np.concatenate([corners[a][None] * (1 - t) + corners[b][None] * t for a, b in edges])


def color_by_ids(ids):
    """The palette's colour of each id (cycling), grey for an id below 0."""
    ids = np.asarray(ids)
    rgb = np.full((len(ids), 3), 128, np.uint8)
    ok = ids >= 0
    rgb[ok] = PALETTE[ids[ok] % len(PALETTE)]
    return rgb


def load_scene(data_root: str, scene: str, synthetic: int = 0):
    """(scan id, xyz, rgb, semantics, instances, superpoints) of
    ``--synthetic`` or of ``data_root``'s validation scene ``scene``."""
    if synthetic:
        from ..data import make_synthetic_scene

        s = make_synthetic_scene(seed=synthetic - 1)
        return (f"synthetic{synthetic - 1:04d}", s.xyz, s.rgb, s.semantic_label,
                s.instance_label, s.spp)
    from ..data import scannet_io

    xyz, rgb, sem, inst = scannet_io.load_scene(
        osp.join(data_root, "val", scene + "_inst_nostuff.pth"))
    spp = scannet_io.load_superpoints(osp.join(data_root, "superpoints", scene + ".pth"))
    return scene, xyz, rgb, sem, inst, spp


def _need(prediction_path) -> None:
    if not prediction_path:
        raise ValueError("--prediction_path required")


def _pointwise(prediction_path, sub: str, scan: str):
    _need(prediction_path)
    return np.load(osp.join(prediction_path, sub, scan + ".npy"))


def instance_ids(prediction_path: str, scan: str, n_points: int, conf_thresh: float):
    """Each point's instance in the benchmark export of ``scan``: the k-th
    mask at or above ``conf_thresh``, in the file's order, is id k (a later
    mask wins a shared point); -1 where none."""
    _need(prediction_path)
    ids = np.full(n_points, -1, np.int64)
    with open(osp.join(prediction_path, scan + ".txt")) as f:
        lines = [ln.split() for ln in f.read().splitlines() if ln]
    k = 0
    for rel, _label, conf in lines:
        if float(conf) < conf_thresh:
            continue
        ids[np.loadtxt(osp.join(prediction_path, rel)).astype(bool)] = k
        k += 1
    return ids


def render(task: str, xyz, rgb, sem, inst, spp, scan: str, prediction_path=None,
           conf_thresh: float = 0.2):
    """(points, colours) that ``task`` draws of one scene."""
    if task == "input_rgb":
        return xyz, np.clip((rgb + 1) * 127.5, 0, 255).astype(np.uint8)
    if task == "semantic_gt":
        return xyz, color_by_ids(sem)
    if task == "instance_gt":
        return xyz, color_by_ids(np.where(inst >= 0, inst, -1))
    if task == "superpoint":
        return xyz, color_by_ids(spp)
    if task == "semantic_pred":
        return xyz, color_by_ids(_pointwise(prediction_path, "semantic_pred", scan))
    if task == "offset_semantic_pred":
        # every point moved by its predicted centre offset, coloured by the
        # predicted class: instances collapse onto their centres
        sem_pred = _pointwise(prediction_path, "semantic_pred", scan)
        return (xyz + _pointwise(prediction_path, "offset_pred", scan),
                color_by_ids(sem_pred))
    if task == "offset_vertices_pred":
        return _vertices(xyz, inst, _pointwise(prediction_path, "offset_vertices_pred", scan))
    if task == "instance_pred":
        return xyz, color_by_ids(instance_ids(prediction_path, scan, len(xyz), conf_thresh))
    raise ValueError(f"unknown task {task!r}")


def _vertices(xyz, inst, corners):
    """The ground-truth instances coloured by size (largest first), and each
    one's box, the mean of its points' predicted corners, as 12 x 24 edge
    points in the instance's colour."""
    ids = np.where(inst >= 0, inst, -1)
    order = np.argsort(-np.bincount(ids[ids >= 0] + 0, minlength=max(ids.max() + 1, 1)))
    rank = np.full(order.max() + 1 if len(order) else 1, -1, np.int64)
    rank[order] = np.arange(len(order))
    colors = color_by_ids(np.where(ids >= 0, rank[np.maximum(ids, 0)], -1))
    box_pts, box_cols = [], []
    box_min = xyz + corners[:, :3]
    box_max = xyz + corners[:, 3:]
    for uid in np.unique(ids[ids >= 0]):
        m = ids == uid
        box_pts.append(_box_edge_points(box_min[m].mean(0), box_max[m].mean(0)))
        box_cols.append(np.tile(PALETTE[rank[uid] % len(PALETTE)], (len(box_pts[-1]), 1)))
    if box_pts:
        xyz = np.concatenate([xyz] + box_pts)
        colors = np.concatenate([colors] + box_cols).astype(np.uint8)
    return xyz, colors


def main(argv=None) -> str:
    ap = argparse.ArgumentParser("gapro_tpu_torch visualization")
    ap.add_argument("--data_root", default="dataset/scannetv2")
    ap.add_argument("--scene", default=None)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--task", default="instance_gt", choices=TASKS)
    ap.add_argument("--prediction_path", default=None)
    ap.add_argument("--conf_thresh", type=float, default=0.2)
    ap.add_argument("--out", default="vis")
    ap.add_argument("--format", default="ply", choices=["ply", "html"],
                    help="ply: any viewer; html: a self-contained interactive WebGL page")
    args = ap.parse_args(argv)

    scan, xyz, rgb, sem, inst, spp = load_scene(args.data_root, args.scene, args.synthetic)
    xyz, colors = render(args.task, xyz, rgb, sem, inst, spp, scan, args.prediction_path,
                         args.conf_thresh)
    out_path = osp.join(args.out, f"{scan}_{args.task}.{args.format}")
    if args.format == "html":
        write_html(out_path, xyz, colors, title=f"{scan} {args.task}")
    else:
        write_ply(out_path, xyz, colors)
    print("wrote", out_path, f"({len(xyz)} points)")
    return out_path


if __name__ == "__main__":
    main()
