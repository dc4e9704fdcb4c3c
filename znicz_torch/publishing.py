"""Reports of a training run (port of ``znicz_tpu/publishing.py``).

:func:`gather_report` collects the workflow's name, the config tree,
each unit's host timing, the Decision's per-class epoch metrics and best
epoch, the run's speed, and the PNGs under ``root.common.dirs.plots``;
:func:`publish` writes it with a backend of :data:`BACKENDS`: Markdown,
HTML or PDF (matplotlib's ``PdfPages``: a title and metrics page, a unit
timing page, one page a plot).  The reference's Confluence backend was
dropped there too.

The speed: when ``FusedTrainer`` trained the workflow, its stats
(``workflow.fused_stats``) as ``fused_img_per_sec``,
``fused_warm_img_per_sec`` and ``fused_train_steps``, the reference's
keys; when ``engine.train`` ran (either engine), the workflow's
``train_stats`` as ``train_steps``, ``img_per_sec`` and
``warm_img_per_sec``.
"""

from __future__ import annotations

import html
import json
import os
import time
from typing import Dict, Optional

from znicz_torch.core.config import root

#: the workflow's ``train_stats`` a report carries
TRAIN_STATS = ("train_steps", "img_per_sec", "warm_img_per_sec")


def gather_report(workflow) -> Dict:
    from znicz_torch.decision import CLASS_NAMES, DecisionBase

    rep: Dict = {
        "name": workflow.name,
        "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "config": root.to_dict(),
        "units": [],
        "metrics": {},
    }
    total = sum(u.run_time for u in workflow.units) or 1e-12
    for u in sorted(workflow.units, key=lambda u: -u.run_time):
        if u.run_count:
            rep["units"].append({"name": u.name, "runs": u.run_count,
                                 "time_s": round(u.run_time, 4),
                                 "pct": round(100 * u.run_time / total, 1)})
    for u in workflow.units:
        if isinstance(u, DecisionBase):
            rep["metrics"]["best_metric"] = float(u.best_metric)
            rep["metrics"]["best_epoch"] = int(u.best_epoch)
            rep["metrics"]["epochs"] = int(u.epoch_number) + 1
            for k, m in enumerate(u.epoch_metrics):
                if m is not None:
                    rep["metrics"][CLASS_NAMES[k]] = {
                        key: (float(v) if isinstance(v, (int, float))
                              else None)
                        for key, v in m.items() if key != "confusion"}
    fused = getattr(workflow, "fused_stats", None)
    if fused and fused.get("wall_s"):
        rep["metrics"]["fused_img_per_sec"] = fused["img_per_sec"]
        rep["metrics"]["fused_warm_img_per_sec"] = \
            fused.get("warm_img_per_sec", 0.0)
        rep["metrics"]["fused_train_steps"] = fused["train_steps"]
    stats = getattr(workflow, "train_stats", None)
    if stats:
        for key in TRAIN_STATS:
            if key in stats:
                rep["metrics"][key] = stats[key]
    plots_dir = root.common.dirs.get("plots")
    if plots_dir and os.path.isdir(plots_dir):
        rep["plots"] = sorted(f for f in os.listdir(plots_dir)
                              if f.endswith(".png"))
    return rep


class MarkdownBackend:
    EXT = ".md"

    def write(self, rep: Dict, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.render(rep))

    def render(self, rep: Dict) -> str:
        lines = [f"# Training report — {rep['name']}", "",
                 f"Generated: {rep['time']}", "", "## Metrics", ""]
        for key, val in rep["metrics"].items():
            lines.append(f"- **{key}**: "
                         f"{json.dumps(val) if isinstance(val, dict) else val}")
        lines += ["", "## Unit timing", "",
                  "| unit | runs | time (s) | % |", "|---|---|---|---|"]
        for u in rep["units"]:
            lines.append(f"| {u['name']} | {u['runs']} | {u['time_s']} "
                         f"| {u['pct']} |")
        for png in rep.get("plots", []):
            lines.append(f"\n![{png}]({png})")
        return "\n".join(lines) + "\n"


class HTMLBackend(MarkdownBackend):
    EXT = ".html"

    def render(self, rep: Dict) -> str:
        md = MarkdownBackend().render(rep)
        body = "".join(f"<p>{html.escape(line)}</p>\n"
                       for line in md.splitlines() if line.strip())
        return (f"<html><head><title>{html.escape(rep['name'])}</title>"
                f"</head><body>{body}</body></html>\n")


class PDFBackend:
    """A4 pages through matplotlib's ``PdfPages``: the title and metrics,
    the unit timing table, then one page a plot PNG."""

    EXT = ".pdf"

    def write(self, rep: Dict, path: str) -> None:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        from matplotlib.backends.backend_pdf import PdfPages

        with PdfPages(path) as pdf:
            fig = plt.figure(figsize=(8.27, 11.69))
            fig.text(0.5, 0.92, f"Training report — {rep['name']}",
                     ha="center", size=18, weight="bold")
            fig.text(0.5, 0.88, f"Generated: {rep['time']}", ha="center",
                     size=10, color="gray")
            lines = [f"{key}: "
                     f"{json.dumps(val) if isinstance(val, dict) else val}"
                     for key, val in rep["metrics"].items()]
            fig.text(0.1, 0.82, "\n".join(lines), va="top", size=11,
                     family="monospace")
            pdf.savefig(fig)
            plt.close(fig)

            if rep["units"]:
                fig, ax = plt.subplots(figsize=(8.27, 11.69))
                ax.axis("off")
                ax.set_title("Unit timing")
                cells = [[u["name"], u["runs"], u["time_s"], u["pct"]]
                         for u in rep["units"]]
                table = ax.table(cellText=cells,
                                 colLabels=["unit", "runs", "time (s)", "%"],
                                 loc="upper center")
                table.auto_set_font_size(False)
                table.set_fontsize(9)
                pdf.savefig(fig)
                plt.close(fig)

            plots_dir = root.common.dirs.get("plots")
            for png in rep.get("plots", []):
                img = plt.imread(os.path.join(plots_dir, png))
                fig, ax = plt.subplots(figsize=(8.27, 11.69))
                ax.imshow(img)
                ax.axis("off")
                ax.set_title(png)
                pdf.savefig(fig)
                plt.close(fig)


BACKENDS = {"markdown": MarkdownBackend, "html": HTMLBackend,
            "pdf": PDFBackend}


def publish(workflow, backend: str = "markdown",
            directory: Optional[str] = None) -> str:
    """Write ``workflow``'s report with ``backend`` into ``directory``
    (default ``root.common.dirs.reports``, else ``reports/``) as
    ``<name>_report<ext>``; returns the path."""
    rep = gather_report(workflow)
    be = BACKENDS[backend]()
    directory = directory or root.common.dirs.get("reports", "reports")
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{workflow.name}_report{be.EXT}")
    be.write(rep, path)
    return path
