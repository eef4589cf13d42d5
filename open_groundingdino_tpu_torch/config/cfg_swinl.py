# Swin-L (the JAX package's config/cfg_swinl.py; reference
# swin_transformer.py swin_L_384_22k entry): window 12, depths 2-2-18-2
_base_ = "cfg_base.py"
backbone = "swin_L_384_22k"
