# Base model hyper-parameters for the PyTorch port of GroundingDINO.
# Values mirror the JAX package's config/cfg_base.py (itself the reference's
# config/cfg_coco.py + tools/GroundingDINO_SwinT_OGC.py): the keys of the
# port's serving and training paths.

modelname = "groundingdino"

# ---- backbone ----------------------------------------------------------------
backbone = "swin_T_224_1k"
position_embedding = "sine"
pe_temperatureH = 20
pe_temperatureW = 20
return_interm_indices = [1, 2, 3]

# ---- transformer --------------------------------------------------------------
enc_layers = 6
dec_layers = 6
dim_feedforward = 2048
hidden_dim = 256
nheads = 8
num_queries = 900
num_feature_levels = 4
enc_n_points = 4
dec_n_points = 4
# the deformable attentions' core op: "gather" (K1 forward, K3 backward; the
# JAX package's default banded path), "sweep" (the tile sweep: the JAX
# package's msda_impl = "pallas" with MSDA_BANDED=0) or "banded_point" (K5
# forward, one band sweep per sample point, K3 backward: the banded path with
# MSDA_BANDED_MP=0)
msda_kernel = "gather"
# the sweep's backward: "corner" (K9) or "rowtap" (K10), the JAX package's
# MSDA_BWD_VARIANT
msda_sweep_bwd = "corner"
# the sweep's forward for decoder-style query sets: K7, K6's kernel under
# its own name, for the JAX package's MSDA_DEC_FUSED=1 (one program for all
# query blocks of a (b, h) there)
msda_dec_fused = False
two_stage_type = "standard"
dec_pred_bbox_embed_share = True

# ---- text ----------------------------------------------------------------
max_text_len = 256
text_encoder_type = "bert-base-uncased"
use_text_enhancer = True
use_fusion_layer = True
use_text_cross_attention = True
use_checkpoint = True            # checkpoint the fusion blocks
use_transformer_ckpt = True      # checkpoint the deformable encoder layers
remat_save_kernels = True        # the checkpointed blocks keep the kernels' outputs (the
                                 # JAX package's REMAT_SAVE_KERNELS): no kernel replays
text_dropout = 0.0
fusion_dropout = 0.0
fusion_droppath = 0.1
sub_sentence_present = True

# ---- losses / matching ---------------------------------------------------
aux_loss = True
set_cost_class = 1.0
set_cost_bbox = 5.0
set_cost_giou = 2.0
cls_loss_coef = 2.0
bbox_loss_coef = 5.0
giou_loss_coef = 2.0
interm_loss_coef = 1.0
no_interm_box_loss = False
focal_alpha = 0.25
focal_gamma = 2.0
matcher_type = "HungarianMatcher"
num_select = 300
nms_iou_threshold = -1
label_list = None           # eval categories when the val set has no cat_list

# ---- optimisation -------------------------------------------------------------
lr = 1e-4
lr_backbone = 1e-5
lr_backbone_names = ["backbone.0", "bert"]
lr_linear_proj_mult = 0.1
lr_linear_proj_names = ["ref_point_head", "sampling_offsets"]
param_dict_type = "ddetr_in_mmdet"
weight_decay = 1e-4
epochs = 12
lr_drop = 11
save_checkpoint_interval = 1
clip_max_norm = 0.1
onecyclelr = False
multi_step_lr = False
lr_drop_list = [33, 45]
freeze_keywords = None
batch_size = 4
steps_per_call = 1          # optimizer steps a call: N > 1 runs chunks of N same-shape
                            # batches through make_multi_train_step, with no host
                            # read between their steps (the JAX package's key)

# ---- data augmentation (reference datasets/transforms.py semantics) -------
data_aug_scales = [480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800]
data_aug_max_size = 1333
data_aug_scales2_resize = [400, 500, 600]
data_aug_scales2_crop = [384, 600]
max_labels = 80  # ODVG pos+neg category sampling cap

# ---- image sizes ------------------------------------------------------------
# Static padded shapes: an image is resized shortest-edge 800 / max 1333 and
# padded up to the smallest bucket that fits (the JAX package's lattice, so
# both packages see the same padded inputs).
image_buckets = [
    (480, 736), (736, 480),
    (608, 928), (928, 608),
    (800, 1216), (1216, 800),
    (800, 1344), (1344, 800),
    (1024, 1024),
]
eval_shortest_edge = 800
eval_max_size = 1333
max_gt_boxes = 128          # static per-image GT padding for the criterion
compute_dtype = "bfloat16"  # training: bf16 compute over f32 master params, f32
                            # AdamW and EMA, as the JAX package's default
                            # (parallel/train_state.py); "float32" for the f32 step
u8_images = True            # ship uint8 pixels, normalize on the device
use_ema = False             # reference cfg use_ema (util/utils.py ModelEma)
ema_decay = 0.9997
ema_epoch = 0
