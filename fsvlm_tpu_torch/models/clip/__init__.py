from .config import ARCHS, CLIPConfig, config_from_state_dict_shapes
from .convert import (
    clip_params_from_state_dict,
    load_jax_params,
    load_openai_checkpoint,
    random_clip_params,
)
from .model import (
    CLIP,
    VisionPrompts,
    clip_logits,
    embed_tokens,
    encode_image,
    encode_image_vit,
    encode_text_embeds,
    encode_text_ids,
    l2_normalize,
)
from .resnet import ModifiedResNet, encode_image_resnet
from .tokenizer import get_tokenizer, tokenize
