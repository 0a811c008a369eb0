"""Self-contained HTML analysis reports, the ``mne.Report`` analog (port of
``ninwavelets_tpu.utils.report``: for the same sections the HTML is the
JAX package's, its default title and footer included).

No reference counterpart — a production pipeline needs a shareable
artifact at the end: this collects matplotlib figures (embedded as
base64 PNGs — ONE file, no sidecar images), tables, and free text into
a navigable HTML document.  Pure host code; figures are rendered with
the Agg canvas so headless/batch jobs work.

    rep = Report(title="Subject 01")
    rep.add_figure("Power", nw.plot_tf(p, show=False).figure)
    rep.add_table("Peaks", {"channel": names, "latency_ms": lats})
    rep.add_text("Notes", "artifact run excluded")
    rep.save("sub-01.html")
"""
from __future__ import annotations

import base64
import html
import io
from typing import Optional

import numpy as np

__all__ = ["Report"]

_CSS = """
body { font-family: -apple-system, 'Segoe UI', sans-serif; margin: 0;
       background: #fafafa; color: #1a1a1a; }
header { background: #1f3a5f; color: #fff; padding: 14px 28px; }
header h1 { margin: 0; font-size: 20px; }
nav { background: #eef1f5; padding: 8px 28px; position: sticky; top: 0; }
nav a { margin-right: 14px; color: #1f3a5f; text-decoration: none;
        font-size: 13px; }
section { background: #fff; margin: 16px 28px; padding: 16px 20px;
          border-radius: 6px; box-shadow: 0 1px 3px rgba(0,0,0,.08); }
section h2 { margin-top: 0; font-size: 16px; color: #1f3a5f; }
img { max-width: 100%; }
table { border-collapse: collapse; font-size: 13px; }
td, th { border: 1px solid #d8dde4; padding: 4px 10px; text-align:
         right; }
th { background: #eef1f5; }
pre { background: #f4f5f7; padding: 10px; border-radius: 4px;
      font-size: 12px; overflow-x: auto; }
footer { color: #888; font-size: 12px; padding: 8px 28px 24px; }
"""


class Report:
    """Accumulate sections, render one self-contained HTML file."""

    def __init__(self, title: str = "ninwavelets_tpu report") -> None:
        self.title = str(title)
        self._sections = []            # (name, html fragment)

    # ------------------------------------------------------------ adders
    def add_figure(self, name: str, fig, caption: Optional[str] = None,
                   dpi: int = 100, close: bool = True) -> None:
        """Embed a matplotlib figure (or anything with ``savefig``) as
        an inline base64 PNG; ``close=True`` releases it afterwards."""
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=dpi, bbox_inches="tight")
        if close:
            import matplotlib.pyplot as plt
            plt.close(fig)
        b64 = base64.b64encode(buf.getvalue()).decode("ascii")
        frag = f'<img alt="{html.escape(name)}" ' \
               f'src="data:image/png;base64,{b64}"/>'
        if caption:
            frag += f"<p><em>{html.escape(caption)}</em></p>"
        self._sections.append((name, frag))

    def add_table(self, name: str, columns: dict,
                  float_fmt: str = "%.4g") -> None:
        """A column-oriented table: ``{header: sequence}`` (columns must
        share a length)."""
        cols = {str(k): list(np.asarray(v).ravel())
                for k, v in columns.items()}
        lengths = {len(v) for v in cols.values()}
        if len(lengths) != 1:
            raise ValueError("table columns must share a length")
        heads = "".join(f"<th>{html.escape(k)}</th>" for k in cols)
        body = []
        for row in zip(*cols.values()):
            cells = []
            for v in row:
                if isinstance(v, (float, np.floating)):
                    cells.append(float_fmt % v)
                else:
                    cells.append(html.escape(str(v)))
            body.append("<tr>" + "".join(f"<td>{c}</td>"
                                         for c in cells) + "</tr>")
        frag = (f"<table><tr>{heads}</tr>" + "".join(body) + "</table>")
        self._sections.append((name, frag))

    def add_text(self, name: str, text: str) -> None:
        """A free-text section (escaped; newlines preserved)."""
        frag = "<pre>" + html.escape(str(text)) + "</pre>"
        self._sections.append((name, frag))

    def add_dict(self, name: str, values: dict) -> None:
        """A key/value summary (scalars; arrays show shape)."""
        rows = []
        for k, v in values.items():
            a = np.asarray(v)
            shown = (("%.6g" % float(a)) if a.ndim == 0
                     else f"array{a.shape}")
            rows.append(f"<tr><th>{html.escape(str(k))}</th>"
                        f"<td>{html.escape(shown)}</td></tr>")
        self._sections.append((name, "<table>" + "".join(rows)
                               + "</table>"))

    # ------------------------------------------------------------ render
    def render(self) -> str:
        nav = "".join(
            f'<a href="#s{i}">{html.escape(n)}</a>'
            for i, (n, _) in enumerate(self._sections))
        body = "".join(
            f'<section id="s{i}"><h2>{html.escape(n)}</h2>{frag}'
            "</section>"
            for i, (n, frag) in enumerate(self._sections))
        return (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(self.title)}</title>"
            f"<style>{_CSS}</style></head><body>"
            f"<header><h1>{html.escape(self.title)}</h1></header>"
            f"<nav>{nav}</nav>{body}"
            "<footer>generated by ninwavelets_tpu</footer>"
            "</body></html>")

    def save(self, path: str) -> str:
        """Write the report; returns the path."""
        out = self.render()
        with open(path, "w", encoding="utf-8") as f:
            f.write(out)
        return path
