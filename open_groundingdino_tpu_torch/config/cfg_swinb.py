# Swin-B (the JAX package's config/cfg_swinb.py; reference
# tools/GroundingDINO_SwinB_cfg.py analog): window 12, depths 2-2-18-2
_base_ = "cfg_base.py"
backbone = "swin_B_384_22k"
