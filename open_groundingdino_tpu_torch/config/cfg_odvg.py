# ODVG mixed OD+VG pretrain / fine-tune config (the JAX package's
# config/cfg_odvg.py; reference config/cfg_odvg.py analog).  Of its keys the
# port reads label_list (the eval categories when a val set has none).
_base_ = "cfg_base.py"
label_list = []
