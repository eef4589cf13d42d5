# Base model hyper-parameters for the PyTorch port of GroundingDINO.
# Values mirror the JAX package's config/cfg_base.py (itself the reference's
# config/cfg_coco.py + tools/GroundingDINO_SwinT_OGC.py).  Only the keys the
# port's serving path reads are kept; the training keys come with the
# training slice.

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
two_stage_type = "standard"
dec_pred_bbox_embed_share = True

# ---- text ----------------------------------------------------------------
max_text_len = 256
text_encoder_type = "bert-base-uncased"
use_text_enhancer = True
use_fusion_layer = True
use_text_cross_attention = True
aux_loss = True

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
