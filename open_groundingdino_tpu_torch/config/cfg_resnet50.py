# COCO config with a ResNet-50 frozen-BN backbone (the JAX package's
# config/cfg_resnet50.py; reference backbone.py:182-196 resnet path).  The
# build reads `dilation` with getattr(args, "dilation", False), as the JAX
# package's does: dilation = True replaces layer4's stride with dilation.
_base_ = ["cfg_coco.py"]

backbone = "resnet50"
dilation = False
return_interm_indices = [1, 2, 3]
