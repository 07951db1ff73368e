"""Saliency evaluation (counterpart of `iip_uavsal_saliency_tpu/evaluation/`):
the seven metrics batched on tensors (`metrics_torch`), the host path
(`metrics_np`, own copy), and the video and image scoring drivers
(`scorer`)."""

from .metrics_np import (
    auc_borji_np,
    auc_judd_np,
    auc_shuffled_np,
    cc_np,
    kld_np,
    nss_np,
    sim_np,
    METRICS_NP,
)
from .metrics_torch import (
    eval_kl,
    eval_cc,
    eval_nss,
    eval_sim,
    eval_auc_judd,
    eval_auc_sweep,
    KEYS_ORDER,
    METRICS_TORCH,
)
from .scorer import (
    KEYS_ORDER as SCORER_KEYS_ORDER,
    build_shuffle_map,
    build_shuffle_map_img,
    collect_all_fixations,
    collect_all_fixations_img,
    evalscores_img,
    evalscores_img_sum,
    evalscores_vid,
    evalscores_vid_sum,
    mean_scores,
    mean_scores_img,
    sample_shufmap,
)
