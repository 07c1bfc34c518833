"""Input preprocessing on the device: normalisation and the train step's
random horizontal flip."""
import torch


def normalize_images(imgs_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 images -> [0, 1] floats (the /255 of the JAX package's
    ops/preprocess.normalize_images)."""
    return imgs_u8.to(dtype) / torch.tensor(255.0, dtype=dtype, device=imgs_u8.device)


def random_hflip(generator: torch.Generator, imgs: torch.Tensor, labels: torch.Tensor,
                 prob: float = 0.5):
    """Flip each (B, H, W, C) image left-right with probability `prob`, and
    mirror its labels' x (labels (B, M, 5 + 3K) [cls, x, y, w, h, kps],
    normalised; keypoint x is bbox-relative and mirrors the same way). The
    draws come from `generator`, on the images' device."""
    flip = torch.rand(imgs.shape[0], generator=generator, device=imgs.device) < prob
    imgs = torch.where(flip[:, None, None, None], imgs.flip(2), imgs)
    x = torch.where(flip[:, None], 1.0 - labels[..., 1], labels[..., 1])
    parts = [labels[..., :1], x[..., None], labels[..., 2:5]]
    if labels.shape[-1] > 5:
        kp = labels[..., 5:].reshape(*labels.shape[:-1], -1, 3)
        kx = torch.where(flip[:, None, None], 1.0 - kp[..., 0], kp[..., 0])
        kp = torch.cat([kx[..., None], kp[..., 1:]], dim=-1)
        parts.append(kp.reshape(*labels.shape[:-1], -1))
    return imgs, torch.cat(parts, dim=-1)
