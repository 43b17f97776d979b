"""Plotting utilities: volume scrolling, filter montages, training reports.

Jax-free copy of ``elektronn2_tpu/utils/plotting.py``; matplotlib is
imported when a plot is drawn, not with this module. Reference: ``elektronn2/utils/plotting.py::scroll_plot, embedfilters, sma,
add_timeticks, plot_hist``. Interactive pieces need a display; everything
here degrades gracefully to file output under Agg.
"""

from __future__ import annotations

import numpy as np

from ..log import logger


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def sma(x, n=10):
    """Simple moving average. Reference: ``plotting.sma``."""
    x = np.asarray(x, np.float64)
    if len(x) < n:
        return x
    c = np.cumsum(np.insert(x, 0, 0))
    return (c[n:] - c[:-n]) / n


def add_timeticks(ax, times, steps, n_ticks=5):
    """Secondary x-axis with wall-clock labels. Reference:
    ``plotting.add_timeticks``."""
    from ..training.trainutils import pretty_string_time
    idx = np.linspace(0, len(steps) - 1, n_ticks).astype(int)
    ax2 = ax.twiny()
    ax2.set_xlim(ax.get_xlim())
    ax2.set_xticks(np.asarray(steps)[idx])
    ax2.set_xticklabels([pretty_string_time(t) for t in
                         np.asarray(times)[idx]], fontsize=7)
    return ax2


def plot_hist(data, path, bins=50, title=""):
    plt = _plt()
    fig, ax = plt.subplots()
    ax.hist(np.asarray(data).ravel(), bins=bins)
    ax.set_title(title)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def embedfilters(filters, path=None, border=1):
    """Montage of conv filters into one image.

    Reference: ``plotting.embedfilters``. ``filters``: (n_out, n_in, *sp);
    3D filters show their central z slice.
    """
    w = np.asarray(filters)
    if w.ndim == 5:              # 3D: take central z slice
        w = w[:, :, w.shape[2] // 2]
    n_out, n_in, h, ww = w.shape
    rows, cols = n_out, n_in
    canvas = np.zeros((rows * (h + border), cols * (ww + border)), np.float32)
    for i in range(rows):
        for j in range(cols):
            f = w[i, j]
            rng = f.max() - f.min()
            f = (f - f.min()) / rng if rng > 0 else f * 0
            canvas[i * (h + border):i * (h + border) + h,
                   j * (ww + border):j * (ww + border) + ww] = f
    if path:
        plt = _plt()
        plt.imsave(path, canvas, cmap="gray")
    return canvas


def scroll_plot(vol, path=None, n_slices=6, cmap="gray"):
    """Volume visualisation.

    Reference: ``plotting.scroll_plot`` is an *interactive* z-scroller; in
    headless use (the normal TPU case) this renders ``n_slices`` evenly
    spaced z slices side by side to ``path`` instead.
    """
    v = np.asarray(vol)
    if v.ndim == 4:
        v = v[0]
    zs = np.linspace(0, v.shape[0] - 1, min(n_slices, v.shape[0])).astype(int)
    plt = _plt()
    fig, axes = plt.subplots(1, len(zs), figsize=(2.2 * len(zs), 2.4))
    if len(zs) == 1:
        axes = [axes]
    for ax, z in zip(axes, zs):
        ax.imshow(v[z], cmap=cmap)
        ax.set_title(f"z={z}", fontsize=8)
        ax.axis("off")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
    return fig


def save_preview_images(pred, path_prefix):
    """Write preview-prediction images (one per class channel).

    Reference: the preview rendering inside ``Trainer.preview_slice``.
    ``pred``: (f, z, x, y) or (f, x, y).
    """
    p = np.asarray(pred)
    if p.ndim == 3:
        p = p[:, None]
    for c in range(p.shape[0]):
        scroll_plot(p[c], f"{path_prefix}-c{c}.png")
    logger.info(f"preview images: {path_prefix}-c*.png")


def my_quiver(x, y, img=None, c=None, path=None):
    """Quiver plot of a 2D vector field, optionally over a background
    image. Reference: ``plotting.my_quiver`` (used to visualise predicted
    tracing direction fields).

    ``x``/``y``: (H, W) vector components; ``img``: optional (H, W)
    greyscale background; ``c``: optional arrow colour array.
    """
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    if img is not None:
        ax.imshow(np.asarray(img), cmap="gray", interpolation="nearest")
    if c is not None:
        ax.quiver(np.asarray(x), np.asarray(y), np.asarray(c), angles="xy")
    else:
        ax.quiver(np.asarray(x), np.asarray(y), angles="xy")
    if path:
        fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return path
    return fig


def plot_trainingtarget(img, lab, stride=1, path=None):
    """Show an image patch beside (and overlaid with) its training target.

    Reference: ``plotting.plot_trainingtarget`` — the quick "is my data
    pipeline sane" visual check. ``img``: (H, W) raw; ``lab``: (h, w)
    target at output ``stride`` (upsampled by repetition for the overlay).
    """
    plt = _plt()
    img = np.asarray(img)
    lab = np.asarray(lab)
    if stride > 1:
        lab = np.repeat(np.repeat(lab, stride, 0), stride, 1)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    axes[0].imshow(img, cmap="gray", interpolation="nearest")
    axes[0].set_title("raw")
    axes[1].imshow(lab, cmap="viridis", interpolation="nearest")
    axes[1].set_title("target")
    axes[2].imshow(img, cmap="gray", interpolation="nearest")
    # centre the (possibly smaller, valid-mode) target on the raw patch
    off = [(a - b) // 2 for a, b in zip(img.shape, lab.shape)]
    ext = (off[1] - 0.5, off[1] + lab.shape[1] - 0.5,
           off[0] + lab.shape[0] - 0.5, off[0] - 0.5)
    axes[2].imshow(lab, cmap="viridis", alpha=0.4,
                   interpolation="nearest", extent=ext)
    axes[2].set_title("overlay")
    for ax in axes:
        ax.axis("off")
    if path:
        fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return path
    return fig


def plot_exectimes(exectimes, path=None, top=20):
    """Horizontal bar chart of per-node execution times.

    Reference: ``plotting.plot_exectimes`` — consumes the dict
    :meth:`Model.measure_exectimes` returns (node name → milliseconds).
    """
    plt = _plt()
    items = sorted(((float(v), str(k)) for k, v in dict(exectimes).items()),
                   reverse=True)[:int(top)]
    vals = [v for v, _ in items][::-1]
    names = [k for _, k in items][::-1]
    fig, ax = plt.subplots(figsize=(7, 0.35 * max(4, len(items)) + 1))
    ax.barh(range(len(vals)), vals)
    ax.set_yticks(range(len(names)))
    ax.set_yticklabels(names, fontsize=7)
    ax.set_xlabel("ms")
    ax.set_title("per-node execution time")
    if path:
        fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return path
    return fig


def plot_kde(x, y, path=None, bins=80, title=""):
    """2D density plot (prediction-vs-target style). Reference:
    ``plotting.plot_kde`` (unverified exact rendering — the reference used
    a KDE scatter; a log-scaled 2D histogram carries the same diagnostic
    without a seaborn dependency)."""
    plt = _plt()
    x = np.asarray(x, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    fig, ax = plt.subplots(figsize=(5, 5))
    h, xe, ye = np.histogram2d(x, y, bins=bins)
    ax.imshow(np.log1p(h.T), origin="lower", aspect="auto",
              extent=(xe[0], xe[-1], ye[0], ye[-1]), cmap="viridis")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    if title:
        ax.set_title(title)
    if path:
        fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return path
    return fig
