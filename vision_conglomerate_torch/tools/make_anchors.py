"""Auto-anchors: k-means and mutation evolution over the label wh
statistics, the JAX package's tools/make_anchors.py (numpy only).

- fitness = mean over boxes of the best min(r, 1/r).min anchor ratio,
  masked by > 1/threshold; BPR (best possible recall) and AAT (anchors
  above threshold) as extras;
- whitened k-means seed, then `num_generations` of random multiplicative
  mutation, keeping the best mutated candidate (the JAX package's choice:
  the reference returned its unmutated seed);
- the predefined anchors are kept when score >= score_tol and bpr >=
  bpr_tol; otherwise the new anchors are written back into `anchors_path`
  when `update_anchors_cfg`, and only there.
"""
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.labels import (get_box_sizes_and_class_weights,
                            get_box_sizes_and_class_weights_from_polygons)
from ..utils.yaml_io import load_yaml, save_yaml

logger = logging.getLogger(__name__)


def ratio_metrics(anchors: np.ndarray, wh_data: np.ndarray, threshold: float = 4.0) -> float:
    r = wh_data[:, None] / anchors[None]
    v = np.minimum(r, 1.0 / r).min(axis=2).max(axis=1)
    m = (v > 1.0 / threshold).astype(np.float64)
    return float((v * m).mean())


def ratio_metrics_w_extras(anchors: np.ndarray, wh_data: np.ndarray,
                           threshold: float = 4.0) -> Tuple[float, float, float]:
    r = wh_data[:, None] / anchors[None]
    v = np.minimum(r, 1.0 / r).min(axis=2).max(axis=1)
    m = (v > 1.0 / threshold).astype(np.float64)
    return float((v * m).mean()), float(m.mean()), float(m.sum())


def _kmeans(data: np.ndarray, k: int, iters: int, rng: np.random.Generator) -> np.ndarray:
    """Plain Lloyd k-means (numpy)."""
    centroids = data[rng.choice(len(data), size=k, replace=False)]
    for _ in range(iters):
        d = ((data[:, None] - centroids[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            pts = data[assign == j]
            if len(pts):
                centroids[j] = pts.mean(0)
    return centroids


def cluster_anchors_w_mutation(
    wh_data: np.ndarray,
    num_anchors: int = 9,
    threshold: float = 4.0,
    num_generations: int = 100,
    kmeans_iter: int = 30,
    verbose: bool = True,
    mut_proba: float = 0.9,
    sigma: float = 0.1,
    seed: int = 0,
) -> Tuple[np.ndarray, float, float, float]:
    rng = np.random.default_rng(seed)

    def log_gen(anchors, gen=None, is_best=False):
        if verbose:
            srt = anchors[np.argsort(anchors.prod(1))]
            score, bpr, aat = ratio_metrics_w_extras(srt, wh_data, threshold)
            tag = "best score" if is_best else "score"
            print(f"Generation: {gen}, BPR: {bpr :.4f}, AAT: {aat :.4f} {tag}={score :.4f}")

    try:
        assert num_anchors <= len(wh_data)
        w_sigma = wh_data.std(0)
        solution = _kmeans(wh_data / w_sigma, num_anchors, kmeans_iter, rng) * w_sigma
        assert solution.shape[0] == num_anchors
    except AssertionError:
        solution = np.sort(rng.random((num_anchors, 2)), axis=0)
    log_gen(solution)

    best_score = ratio_metrics(solution, wh_data, threshold)
    best_solution = solution
    best_gen = None
    for gen in range(num_generations):
        mut = np.ones_like(solution)
        while (mut == 1).all():
            mut = ((rng.random(solution.shape) > mut_proba)
                   * rng.random() * rng.standard_normal(solution.shape) * sigma) + 1
        cand = solution * mut
        score = ratio_metrics(cand, wh_data, threshold)
        is_best = score > best_score
        if is_best:
            best_gen, best_solution, best_score = gen, cand, score
        log_gen(cand, gen, is_best)

    best_solution = best_solution[np.argsort(best_solution.prod(-1))]
    best_score, bpr, aat = ratio_metrics_w_extras(best_solution, wh_data, threshold)
    if verbose:
        print(f"best solution: {best_solution}")
        print(f"best score is {best_score :.4f} @ generation {best_gen}")
        print(f"Best Possible Recall: {bpr :.4f}")
        print(f"Anchors Above Threshold: {aat}")
    return best_solution, best_score, bpr, aat


def generate_anchors_and_class_weights(
    labels_path: str,
    predefined_anchors: Dict[str, List[List[float]]],
    threshold: float = 4.0,
    score_tol: float = 0.8,
    bpr_tol: float = 0.95,
    verbose: bool = True,
    update_anchors_cfg: bool = True,
    anchors_path: Optional[str] = None,
    from_polygons: bool = False,
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (anchors (3, 3, 2) float32, class_weights). `from_polygons`
    reads polygon (segmentation) labels and takes each polygon's box."""
    predefined = np.concatenate([
        np.asarray(predefined_anchors["sm"], np.float32),
        np.asarray(predefined_anchors["md"], np.float32),
        np.asarray(predefined_anchors["lg"], np.float32),
    ], axis=0)
    num_anchors = predefined.shape[0]

    wh_data, class_weights = (get_box_sizes_and_class_weights_from_polygons if from_polygons
                              else get_box_sizes_and_class_weights)(labels_path)

    score, bpr, aat = ratio_metrics_w_extras(predefined, wh_data, threshold)
    if score >= score_tol and bpr >= bpr_tol:
        logger.info("Current anchors are a good fit for the dataset")
        anchors = predefined.reshape(3, 3, 2)
    else:
        logger.info("Current anchors are a poor fit for the dataset, attempting to improve:")
        anchors, new_score, new_bpr, new_aat = cluster_anchors_w_mutation(
            wh_data, num_anchors, threshold, verbose=verbose, **kwargs)
        anchors = anchors.reshape(3, 3, 2).astype(np.float32)
        if new_score > score and new_bpr >= bpr:
            logger.info("Calculated anchors are a better fit than the previous anchors")
        if new_score > score_tol and new_bpr >= bpr_tol:
            logger.info("Calculated anchors are a good fit for the dataset")
        else:
            logger.info("Unfortunately, the calculated anchors are still a poor fit for the dataset")
        if update_anchors_cfg and anchors_path:
            cfg = load_yaml(anchors_path) or {}
            cfg.setdefault("anchors", {})
            cfg["anchors"]["sm"] = anchors[0].tolist()
            cfg["anchors"]["md"] = anchors[1].tolist()
            cfg["anchors"]["lg"] = anchors[2].tolist()
            save_yaml(cfg, anchors_path)
            logger.info(f"{anchors_path} has successfully been updated with the calculated anchors")
    return anchors.astype(np.float32), class_weights.astype(np.float32)
