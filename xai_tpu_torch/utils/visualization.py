"""Attribution rendering (util/visualization.py): percentile-threshold
normalization + overlay subplot helper.

Counterpart of ``xai_tpu/utils/visualization.py``, host numpy; matplotlib
is imported only inside the functions that draw.
"""
from __future__ import annotations

import numpy as np


def _cumulative_sum_threshold(values: np.ndarray, percentile: float):
    sorted_vals = np.sort(values.ravel())
    cum = np.cumsum(sorted_vals)
    idx = np.where(cum >= cum[-1] * 0.01 * percentile)[0][0]
    return sorted_vals[idx]


def normalize_attr(attr: np.ndarray, norm: str = "absolute",
                   outlier_perc: float = 2,
                   reduction_axis: int = 2) -> np.ndarray:
    """_normalize_attr (visualization.py:15-31): channel-sum, signed
    selection, outlier-percentile scale, clip to [-1, 1]."""
    a = np.asarray(attr, np.float64)
    if a.ndim > 2:
        a = a.sum(axis=reduction_axis)
    if norm == "absolute":
        a = np.abs(a)
        threshold = _cumulative_sum_threshold(a, 100 - outlier_perc)
    elif norm == "positive":
        a = (a > 0) * a
        threshold = _cumulative_sum_threshold(a, 100 - outlier_perc)
    elif norm == "negative":
        a = (a < 0) * a
        threshold = -_cumulative_sum_threshold(np.abs(a),
                                               100 - outlier_perc)
    elif norm == "all":
        threshold = _cumulative_sum_threshold(a, 100 - outlier_perc)
    else:
        raise ValueError(norm)
    return np.clip(a / threshold, -1, 1)


def attr_to_subplot(attr, title, axs, norm: str = "absolute", cmap=None,
                    original_image: bool = False, blended_image=None,
                    alpha: float = 0.5):
    """attr_to_subplot (visualization.py:33-81)."""
    from matplotlib.colors import LinearSegmentedColormap

    axs.set_title(title)
    if original_image:
        axs.imshow(np.asarray(attr))
    else:
        if norm == "absolute":
            norm_cmap = LinearSegmentedColormap.from_list(
                "custom blue",
                [(0, (1, 1, 1, 1)), (0.25, "#0000ff"), (1, "#0000ff")],
                N=256)
            vmin, vmax = 0, 1
        elif norm == "positive":
            norm_cmap, vmin, vmax = "Greens", 0, 1
        elif norm == "negative":
            norm_cmap, vmin, vmax = "Reds", 0, 1
        elif norm == "all":
            norm_cmap = LinearSegmentedColormap.from_list(
                "RdGn", ["red", "white", "blue"])
            vmin, vmax = -1, 1
        else:
            raise ValueError(norm)
        cmap = cmap or norm_cmap
        if blended_image is not None:
            axs.imshow(np.asarray(blended_image))
            axs.imshow(normalize_attr(attr, norm), cmap=cmap, vmin=vmin,
                       vmax=vmax, alpha=alpha)
        else:
            axs.imshow(normalize_attr(attr, norm), cmap=cmap, vmin=vmin,
                       vmax=vmax)
    axs.set_xticks([])
    axs.set_yticks([])


def enlarge_image(img: np.ndarray, scaling: int = 3) -> np.ndarray:
    """Pixel-replication upscale (evaluations/utils/render.py:35-82)."""
    if scaling < 1 or int(scaling) != scaling:
        raise ValueError("scaling factor needs to be an int >= 1")
    reps = (scaling, scaling) + (1,) * (img.ndim - 2)
    return np.kron(img, np.ones(reps, dtype=img.dtype))


def hm_to_rgb(R: np.ndarray, X: np.ndarray | None = None, scaling: int = 3,
              cmap: str = "bwr", normalize: bool = True,
              sigma: float = 2) -> np.ndarray:
    """Heatmap -> RGB image (evaluations/utils/render.py:153-216, used by
    the reference's HDF5 results reader expl_hdf5.py:47).  The outline
    branch is dead code upstream (the canny call is commented out at
    render.py:213-216) but its documented semantics — multiply a black
    canny-edge outline of ``X`` onto the heatmap — are implemented here
    via the native detector in utils/render.py (skimage-free)."""
    import matplotlib.cm
    R = np.asarray(R, dtype=np.float64)
    if normalize:
        R = R / np.max(np.abs(R))
        R = (R + 1.0) / 2.0
    R = enlarge_image(R, scaling)
    cm = matplotlib.colormaps[cmap]
    rgb = cm(R.reshape(-1))[..., 0:3].reshape(R.shape[0], R.shape[1], 3)
    if X is not None:
        from .render import canny
        Xl = enlarge_image(np.asarray(X, np.float64), scaling)
        if Xl.shape == rgb.shape[:2]:
            edges = canny(Xl, sigma=sigma)
            rgb = rgb * (~np.dstack([edges] * 3)).astype(rgb.dtype)
    return rgb
