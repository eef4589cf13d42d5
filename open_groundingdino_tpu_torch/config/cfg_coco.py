# COCO fine-tune / zero-shot eval config (reference config/cfg_coco.py analog)
_base_ = "cfg_base.py"
use_coco_eval = True
