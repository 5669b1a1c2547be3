"""Predicted-against-ground-truth 3D overlay as a plotly-format HTML file
(numpy and JSON only).

Port of the parts of ``dynamicpdb_tpu/analysis/interactive.py`` that
``sampling/evaluate.py`` writes with ``save_dir``: ``comparison_figure``
(two Scatter3d traces of C-alpha positions) and ``write_html`` (a
self-contained viewer that loads plotly.js from its CDN; the figure JSON
is embedded, so the file is also a data artifact offline). The figures are
plain dicts in plotly's JSON schema; no plotly package is needed.
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


def figure(traces: list, layout: dict | None = None,
           frames: list | None = None) -> dict:
    fig = {"data": list(traces), "layout": layout or static_layout()}
    if frames is not None:
        fig["frames"] = frames
    return fig


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
