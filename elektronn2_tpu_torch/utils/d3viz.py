"""Interactive HTML visualisation of a model graph.

Jax-free copy of ``elektronn2_tpu/utils/d3viz.py`` (reference:
``elektronn2/utils/d3viz/``, vendored Theano d3viz). Rebuilt as a
single self-contained HTML file (embedded SVG + vanilla JS, no vendored
library): nodes laid out by graph depth, edges as curves, hover shows
shape/params. ``visualise_model(model, path)`` writes ``path``.
"""

from __future__ import annotations

import html
import json


def _graph_json(model):
    nodes, edges = [], []
    depth = {}
    for node in model.nodes.values():
        d = (max((depth[p.name] for p in node.parents), default=-1) + 1)
        depth[node.name] = d
        role = ""
        for attr in ("input_node", "target_node", "loss_node",
                     "prediction_node", "error_node"):
            if getattr(model, attr, None) is node:
                role = attr.replace("_node", "")
        nodes.append({
            "name": node.name, "cls": type(node).__name__, "depth": d,
            "shape": list(node.shape) if node.shape is not None else [],
            "n_params": node.param_count, "role": role,
        })
        for p in node.parents:
            edges.append({"src": p.name, "dst": node.name})
    return nodes, edges


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
body {{ font: 12px sans-serif; background: #fafafa; }}
.node rect {{ fill: #e8eefc; stroke: #4a6fb8; rx: 4; }}
.node.role-loss rect {{ fill: #fde2e2; stroke: #b84a4a; }}
.node.role-input rect, .node.role-target rect {{ fill: #e2f5e5; stroke: #3c9c51; }}
.node.role-prediction rect {{ fill: #fdf3d8; stroke: #c09326; }}
.node text {{ pointer-events: none; }}
.edge {{ stroke: #999; fill: none; marker-end: url(#arrow); }}
#tip {{ position: absolute; background: #222; color: #eee; padding: 6px 8px;
       border-radius: 4px; visibility: hidden; font-size: 11px; }}
</style></head><body>
<h3>{title}</h3><div id="tip"></div>
<svg id="g" width="100%" height="2000">
<defs><marker id="arrow" viewBox="0 0 10 10" refX="9" refY="5"
 markerWidth="6" markerHeight="6" orient="auto">
 <path d="M0,0L10,5L0,10z" fill="#999"/></marker></defs></svg>
<script>
const nodes = {nodes};
const edges = {edges};
const svg = document.getElementById('g');
const tip = document.getElementById('tip');
const W = 170, H = 40, GX = 40, GY = 70;
const perDepth = {{}};
nodes.forEach(n => {{
  n.col = (perDepth[n.depth] = (perDepth[n.depth] ?? -1) + 1);
  n.x = 20 + n.col * (W + GX); n.y = 20 + n.depth * GY;
}});
const byName = Object.fromEntries(nodes.map(n => [n.name, n]));
edges.forEach(e => {{
  const a = byName[e.src], b = byName[e.dst];
  const p = document.createElementNS('http://www.w3.org/2000/svg','path');
  p.setAttribute('class','edge');
  p.setAttribute('d',`M${{a.x+W/2}},${{a.y+H}} C${{a.x+W/2}},${{a.y+H+30}} `+
                 `${{b.x+W/2}},${{b.y-30}} ${{b.x+W/2}},${{b.y}}`);
  svg.appendChild(p);
}});
nodes.forEach(n => {{
  const grp = document.createElementNS('http://www.w3.org/2000/svg','g');
  grp.setAttribute('class','node role-'+n.role);
  grp.setAttribute('transform',`translate(${{n.x}},${{n.y}})`);
  const r = document.createElementNS('http://www.w3.org/2000/svg','rect');
  r.setAttribute('width',W); r.setAttribute('height',H);
  grp.appendChild(r);
  const t1 = document.createElementNS('http://www.w3.org/2000/svg','text');
  t1.setAttribute('x',6); t1.setAttribute('y',16);
  t1.textContent = n.name + (n.role ? ' ['+n.role+']' : '');
  const t2 = document.createElementNS('http://www.w3.org/2000/svg','text');
  t2.setAttribute('x',6); t2.setAttribute('y',32);
  t2.setAttribute('fill','#666');
  t2.textContent = n.cls + ' ' + JSON.stringify(n.shape);
  grp.appendChild(t1); grp.appendChild(t2);
  grp.onmousemove = ev => {{
    tip.style.visibility='visible';
    tip.style.left = (ev.pageX+12)+'px'; tip.style.top = (ev.pageY+12)+'px';
    tip.textContent = `${{n.cls}} ${{n.name}} shape=${{JSON.stringify(n.shape)}} params=${{n.n_params}}`;
  }};
  grp.onmouseleave = () => tip.style.visibility='hidden';
  svg.appendChild(grp);
}});
svg.setAttribute('height', 40 + GY * (1 + Math.max(...nodes.map(n=>n.depth))));
</script></body></html>"""


def visualise_model(model, path):
    """Write a self-contained interactive HTML graph view of ``model``."""
    nodes, edges = _graph_json(model)
    doc = _TEMPLATE.format(title=html.escape(f"model graph: {model.name}"),
                           nodes=json.dumps(nodes),
                           edges=json.dumps(edges))
    with open(path, "w") as f:
        f.write(doc)
    return path
