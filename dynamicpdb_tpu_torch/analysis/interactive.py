"""Interactive 3D trajectory views as plotly-format figures and HTML files
(numpy and JSON only).

Port of ``dynamicpdb_tpu/analysis/interactive.py``: Scatter3d traces, Cone
glyphs for force or velocity vectors, an animated layout with a Play
button and a slider (``trajectory_figure``), the predicted-against-ground-
truth overlay ``sampling/evaluate.py`` writes with ``save_dir``
(``comparison_figure``), and ``write_html``, a self-contained viewer that
loads plotly.js from its CDN (the figure JSON is embedded, so the file is
also a data artifact offline). The figures are plain dicts in plotly's
JSON schema; no plotly package is needed.
"""
from __future__ import annotations

import json

import numpy as np

_CDN = "https://cdn.plot.ly/plotly-2.27.0.min.js"


def scatter3d(pos_3d, mode: str = "markers", marker_size: int | None = None,
              name: str | None = None, opacity: float | None = None,
              color=None, colorscale: str | None = None) -> dict:
    """Scatter3d trace dict from [N, 3] points (create_scatter parity,
    plotting.py:15-59)."""
    pos_3d = np.asarray(pos_3d, dtype=float)
    trace = {
        "type": "scatter3d",
        "x": pos_3d[:, 0].tolist(),
        "y": pos_3d[:, 1].tolist(),
        "z": pos_3d[:, 2].tolist(),
        "mode": mode,
        "marker": {},
    }
    if marker_size is not None:
        trace["marker"]["size"] = marker_size
    if name:
        trace["name"] = name
    if opacity is not None:
        trace["opacity"] = opacity
    if color is not None:
        trace["marker"]["color"] = (
            color if isinstance(color, str) else list(color)
        )
    if colorscale:
        trace["marker"]["colorscale"] = colorscale
    return trace


def cones(tail_3d, head_3d, sizemode: str = "absolute",
          name: str | None = None, opacity: float | None = None,
          sizeref: float | None = None) -> dict:
    """Cone trace dict: vector glyphs (forces/velocities) with tails at
    tail_3d and directions head_3d (create_cones parity, plotting.py:62-98)."""
    tail_3d = np.asarray(tail_3d, dtype=float)
    head_3d = np.asarray(head_3d, dtype=float)
    trace = {
        "type": "cone",
        "x": tail_3d[:, 0].tolist(),
        "y": tail_3d[:, 1].tolist(),
        "z": tail_3d[:, 2].tolist(),
        "u": head_3d[:, 0].tolist(),
        "v": head_3d[:, 1].tolist(),
        "w": head_3d[:, 2].tolist(),
        "sizemode": sizemode,
    }
    if name:
        trace["name"] = name
    if opacity is not None:
        trace["opacity"] = opacity
    if sizeref is not None:
        trace["sizeref"] = sizeref
    return trace


def static_layout(height: int = 500, width: int = 600,
                  title: str | None = None,
                  scene_range: tuple | None = None) -> dict:
    layout: dict = {"height": height, "width": width, "autosize": False}
    if scene_range is not None:
        axis = {"range": list(scene_range)}
        layout["scene"] = {
            "xaxis": dict(axis), "yaxis": dict(axis), "zaxis": dict(axis),
            "aspectmode": "cube",
        }
    if title:
        layout["title"] = {"text": title}
    return layout


def dynamic_layout(height: int = 500, width: int = 600,
                   title: str | None = None,
                   scene_range: tuple | None = None,
                   frame_ms: int = 30) -> dict:
    """Animated layout with a Play button (create_dynamic_layout parity,
    plotting.py:148-195)."""
    layout = static_layout(height, width, title, scene_range)
    layout["updatemenus"] = [{
        "buttons": [{
            "args": [None, {"frame": {"duration": frame_ms},
                            "transition": {"duration": frame_ms}}],
            "label": "Play",
            "method": "animate",
        }],
        "direction": "left",
        "pad": {"r": 10, "t": 87},
        "showactive": False,
        "type": "buttons",
        "x": 0.1, "xanchor": "right", "y": 0, "yanchor": "top",
    }]
    return layout


def figure(traces: list, layout: dict | None = None,
           frames: list | None = None) -> dict:
    fig = {"data": list(traces), "layout": layout or static_layout()}
    if frames is not None:
        fig["frames"] = frames
    return fig


def trajectory_figure(ca_traj, forces=None, stride: int = 1,
                      title: str | None = None,
                      marker_size: int = 3, cone_sizeref: float = 2.0,
                      frame_ms: int = 30) -> dict:
    """Animated CA-trace viewer over a [T, N, 3] trajectory (atom37 input
    [T, N, 37, 3] also accepted — CA column extracted). Optional [T, N, 3]
    force/velocity vectors become cone glyphs per frame."""
    ca_traj = np.asarray(ca_traj, dtype=float)
    if ca_traj.ndim == 4:
        ca_traj = ca_traj[:, :, 1]
    ca_traj = ca_traj[::stride]
    if forces is not None:
        forces = np.asarray(forces, dtype=float)[::stride]

    lo = float(ca_traj.min()) - 2.0
    hi = float(ca_traj.max()) + 2.0

    def frame_traces(t):
        tr = [scatter3d(ca_traj[t], mode="lines+markers",
                        marker_size=marker_size, name="CA",
                        color=list(range(ca_traj.shape[1])),
                        colorscale="Viridis")]
        if forces is not None:
            tr.append(cones(ca_traj[t], forces[t], name="force",
                            opacity=0.6, sizeref=cone_sizeref))
        return tr

    frames = [{"name": str(t), "data": frame_traces(t)}
              for t in range(len(ca_traj))]
    layout = dynamic_layout(title=title, scene_range=(lo, hi),
                            frame_ms=frame_ms)
    layout["sliders"] = [{
        "steps": [{
            "args": [[str(t)], {"frame": {"duration": 0},
                                "mode": "immediate"}],
            "label": str(t), "method": "animate",
        } for t in range(len(ca_traj))],
        "x": 0.1, "len": 0.9,
    }]
    return figure(frame_traces(0), layout, frames=frames)


def comparison_figure(pred_ca, gt_ca, title: str | None = None) -> dict:
    """Static predicted-vs-GT overlay ([N, 3] each), like the reference's
    qualitative side-by-side renders."""
    return figure(
        [
            scatter3d(np.asarray(pred_ca), mode="lines+markers",
                      marker_size=3, name="predicted", opacity=0.9),
            scatter3d(np.asarray(gt_ca), mode="lines+markers",
                      marker_size=3, name="ground truth", opacity=0.5),
        ],
        static_layout(title=title),
    )


def to_json(fig: dict) -> str:
    """Serialized figure; loads in plotly via plotly.io.from_json."""
    return json.dumps(fig)


def write_html(fig: dict, path: str, div_id: str = "figure") -> str:
    """Self-contained HTML viewer (plotly.js from CDN; the figure JSON is
    embedded, so the file also serves as a data artifact offline)."""
    # '</' inside the embedded JSON (e.g. a protein name containing
    # '</script>') would terminate the script block early / inject markup;
    # the standard JSON-in-HTML escape keeps the payload identical after
    # JSON.parse ('<\/' parses to '</')
    payload = to_json(fig).replace("</", "<\\/")
    html = f"""<!DOCTYPE html>
<html>
<head><meta charset="utf-8"><script src="{_CDN}"></script></head>
<body>
<div id="{div_id}"></div>
<script type="application/json" id="{div_id}-data">{payload}</script>
<script>
  var fig = JSON.parse(
    document.getElementById("{div_id}-data").textContent);
  Plotly.newPlot("{div_id}", fig.data, fig.layout).then(function() {{
    if (fig.frames) Plotly.addFrames("{div_id}", fig.frames);
  }});
</script>
</body>
</html>
"""
    with open(path, "w") as f:
        f.write(html)
    return path
