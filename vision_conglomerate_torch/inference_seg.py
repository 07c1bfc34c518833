"""Segmentation inference CLI of the port, with the flags of the JAX
package's inference_seg.py (those of inference_det plus `--crop_masks`);
`--device` defaults to `cuda`.

    python -m vision_conglomerate_torch.inference_seg --path imgs/ --with_summary
    python -m vision_conglomerate_torch.inference_seg --path clip.mp4 --frame_skips 1

As in the JAX package's CLI, the config is
saved_model/segmentation/best_model/config/config.yaml and the weights
default to SegmentationNet.ckpt.tar in saved_model/segmentation/best_model/.
Between NMS and drawing, each kept box's mask is assembled: sigmoid(protos .
coefs), bilinear to the original size, > 0.5, and drawn under the boxes;
`--crop_masks` zeroes each mask outside its box first.
"""
import logging
import os
from pathlib import Path

from .inference_det import LOG_DATE_FORMAT, LOG_FORMAT, build_parser, run

BEST_MODEL_PATH = "saved_model/segmentation/best_model/SegmentationNet.ckpt.tar"


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt=LOG_DATE_FORMAT)
    parser = build_parser(BEST_MODEL_PATH)
    parser.description = "Segmentation Inference"
    parser.add_argument("--crop_masks", action="store_true",
                        help="Crop assembled masks to their predicted boxes before drawing")
    args = parser.parse_args(argv)
    config_path = os.path.join(Path(BEST_MODEL_PATH).parent.resolve(), "config", "config.yaml")
    return run(args, config_path, task="segmentation")


if __name__ == "__main__":
    main()
