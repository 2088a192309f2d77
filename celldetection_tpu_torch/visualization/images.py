"""Plotting helpers (matplotlib, imported on use, with the ``Agg`` backend).

Counterpart of ``celldetection_tpu/visualization/images.py``: ``imshow``,
``imshow_row``/``_grid``/``_col``, ``plot_contours``, ``plot_boxes``,
``plot_score``, ``plot_text``, ``plot_mask``, ``show_detection``,
``quiver_plot``, ``figure2img``, ``save_fig``, ``get_axes``, ``plot_zstack``
and ``plot_gif``. Every array argument may be a numpy array or a CPU or CUDA
tensor; a tensor is copied to the host (:func:`to_host`) before it is drawn.
"""
import numpy as np

__all__ = ['imshow', 'imshow_row', 'imshow_grid', 'imshow_col', 'plot_contours', 'plot_boxes',
           'plot_score', 'plot_text', 'plot_mask', 'show_detection', 'quiver_plot',
           'figure2img', 'save_fig', 'get_axes', 'plot_zstack', 'plot_gif', 'to_host']


def _plt():
    import matplotlib
    matplotlib.use('Agg', force=False)
    import matplotlib.pyplot as plt
    return plt


def to_host(x) -> np.ndarray:
    """A numpy array of ``x``: a tensor (on any device, bf16 as float32) is
    detached and copied to the host; anything else goes through ``np.asarray``."""
    if hasattr(x, 'detach') and hasattr(x, 'cpu'):
        x = x.detach().cpu()
        if x.dtype.is_floating_point and x.element_size() < 4:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _host_list(xs):
    return None if xs is None else [to_host(x) for x in xs]


def imshow(image, figsize=None, ax=None, **kwargs):
    plt = _plt()
    if ax is None:
        if figsize is not None:
            plt.figure(figsize=figsize)
        ax = plt.gca()
    image = to_host(image)
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    ax.imshow(image, cmap=kwargs.pop('cmap', 'gray' if image.ndim == 2 else None), **kwargs)
    ax.axis('off')
    return ax


def imshow_row(*images, figsize=(16, 9), titles=None, **kwargs):
    plt = _plt()
    fig, axes = plt.subplots(1, len(images), figsize=figsize)
    if len(images) == 1:
        axes = [axes]
    for i, (ax, im) in enumerate(zip(axes, images)):
        imshow(im, ax=ax, **kwargs)
        if titles:
            ax.set_title(titles[i])
    return fig


def imshow_grid(images, cols=4, figsize=(16, 9), **kwargs):
    plt = _plt()
    rows = int(np.ceil(len(images) / cols))
    fig, axes = plt.subplots(rows, cols, figsize=figsize)
    axes = np.atleast_1d(axes).ravel()
    for ax, im in zip(axes, images):
        imshow(im, ax=ax, **kwargs)
    for ax in axes[len(images):]:
        ax.axis('off')
    return fig


def imshow_col(*images, figsize=(9, 16), titles=None, **kwargs):
    """Images stacked vertically."""
    plt = _plt()
    fig, axes = plt.subplots(len(images), 1, figsize=figsize)
    if len(images) == 1:
        axes = [axes]
    for i, (ax, im) in enumerate(zip(axes, images)):
        imshow(im, ax=ax, **kwargs)
        if titles:
            ax.set_title(titles[i])
    return fig


def plot_contours(contours, ax=None, color=None, linestyle='-', linewidth=1.5, fill=0.,
                  texts=None, **kwargs):
    plt = _plt()
    ax = ax or plt.gca()
    for i, con in enumerate(contours):
        con = to_host(con)
        closed = np.concatenate([con, con[:1]], 0)
        line, = ax.plot(closed[:, 0], closed[:, 1], linestyle=linestyle,
                        linewidth=linewidth, color=color, **kwargs)
        if fill:
            ax.fill(closed[:, 0], closed[:, 1], alpha=fill, color=line.get_color())
        if texts is not None:
            plot_text(str(texts[i]), con[:, 0].mean(), con[:, 1].min(), ax=ax)
    return ax


def plot_boxes(boxes, ax=None, color='deepskyblue', linewidth=1.0, **kwargs):
    plt = _plt()
    from matplotlib.patches import Rectangle
    ax = ax or plt.gca()
    for b in to_host(boxes).reshape(-1, 4):
        x0, y0, x1, y1 = b
        ax.add_patch(Rectangle((x0, y0), x1 - x0, y1 - y0, fill=False,
                               edgecolor=color, linewidth=linewidth, **kwargs))
    return ax


def plot_score(scores, locations, ax=None, fmt='{:.2f}', **kwargs):
    plt = _plt()
    ax = ax or plt.gca()
    for s, (x, y) in zip(to_host(scores).reshape(-1), to_host(locations).reshape(-1, 2)):
        plot_text(fmt.format(float(s)), x, y, ax=ax, **kwargs)
    return ax


def plot_text(text, x, y, ax=None, color='black', backgroundcolor='white', fontsize=8, **kwargs):
    plt = _plt()
    ax = ax or plt.gca()
    ax.text(x, y, text, color=color, backgroundcolor=backgroundcolor, fontsize=fontsize,
            ha='center', **kwargs)
    return ax


def plot_mask(mask, ax=None, alpha=0.4, color=(0.2, 0.6, 1.0)):
    plt = _plt()
    ax = ax or plt.gca()
    mask = to_host(mask).astype(bool)
    overlay = np.zeros(mask.shape + (4,))
    overlay[mask] = (*color, alpha)
    ax.imshow(overlay)
    return ax


def show_detection(image=None, contours=None, boxes=None, scores=None, locations=None,
                   classes=None, class_names=None, figsize=(16, 9),
                   contour_linestyle='-', ax=None, **kwargs):
    """Image, contours, boxes and scores in one figure; ``classes`` (ids or
    names, one per detection) with ``class_names`` (id → name) label each
    contour ``"<score> <class>"``."""
    plt = _plt()
    if ax is None:
        plt.figure(figsize=figsize)
        ax = plt.gca()
    if image is not None:
        imshow(image, ax=ax)
    texts = kwargs.pop('texts', None)
    if texts is None and scores is not None and (classes is not None or class_names is not None):
        texts = []
        if classes is not None and not isinstance(classes, (list, tuple)):
            classes = to_host(classes)
        for i, s in enumerate(to_host(scores).reshape(-1)):
            label = f'{float(s):.2f}'
            if classes is not None:
                c = classes[i]
                if class_names is not None and not isinstance(c, str):
                    c = class_names.get(int(c), int(c))
                label = f'{label} {c}'
            texts.append(label)
    if contours is not None:
        plot_contours(_host_list(contours), ax=ax, linestyle=contour_linestyle, texts=texts,
                      **kwargs)
    if boxes is not None:
        plot_boxes(boxes, ax=ax)
    if scores is not None and locations is not None and texts is None:
        plot_score(scores, locations, ax=ax)
    return ax


def quiver_plot(field, ax=None, stride=8, **kwargs):
    """Quiver plot of an ``(h, w, 2)`` vector field (a flow or refinement field)."""
    plt = _plt()
    ax = ax or plt.gca()
    field = to_host(field)
    h, w = field.shape[:2]
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    ax.quiver(xs, ys, field[::stride, ::stride, 0], field[::stride, ::stride, 1], **kwargs)
    return ax


def figure2img(fig, transparent=False) -> np.ndarray:
    """A matplotlib figure as the uint8 RGBA array of its PNG."""
    import io
    from PIL import Image
    buf = io.BytesIO()
    fig.savefig(buf, format='png', transparent=transparent, bbox_inches='tight')
    buf.seek(0)
    return np.asarray(Image.open(buf))


def save_fig(filename, fig=None, close=True, **kwargs):
    plt = _plt()
    fig = fig or plt.gcf()
    fig.savefig(filename, bbox_inches='tight', **kwargs)
    if close:
        plt.close(fig)


def get_axes(fig=None):
    """All axes of a figure (the current figure by default)."""
    plt = _plt()
    return (fig or plt.gcf()).get_axes()


def plot_zstack(stack, project=None, cols=4, titles=None, figsize=(16, 9), **kwargs):
    """A z-stack ``[z, h, w(, c)]`` as a grid of slices, or as one projection
    over z (``project``: 'max', 'mean' or a callable)."""
    stack = to_host(stack)
    if project is not None:
        fn = {'max': np.max, 'mean': np.mean}.get(project, project)
        return imshow(fn(stack, axis=0), **kwargs)
    return imshow_grid(list(stack), cols=cols, figsize=figsize, **kwargs)


def plot_gif(*frames, fn=None, interval=200, **kwargs):
    """Animate frames; save them as a GIF to ``fn`` when given."""
    plt = _plt()
    from matplotlib import animation

    fig = plt.figure()
    ax = fig.add_subplot(1, 1, 1)
    ax.axis('off')
    ims = [[ax.imshow(to_host(f).squeeze(), animated=True, **kwargs)] for f in frames]
    ani = animation.ArtistAnimation(fig, ims, interval=interval, blit=True)
    if fn is not None:
        ani.save(fn, writer=animation.PillowWriter(fps=max(1, int(1000 / interval))))
    return ani
