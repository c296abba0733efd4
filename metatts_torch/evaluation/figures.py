"""Figure grid stitching (reference ``evaluation/merge_image.py``): tile a
set of PNGs (e.g., per-adaptation-step spectrograms) into one comparison
image.  matplotlib is imported inside the function."""

import os


def merge_images(paths, out_path, cols=4, titles=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.image as mpimg

    n = len(paths)
    if n == 0:
        raise ValueError("no images to merge")
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 2.6 * rows),
                             squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i < n:
            ax.imshow(mpimg.imread(paths[i]))
            if titles and i < len(titles):
                ax.set_title(str(titles[i]), fontsize=8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
