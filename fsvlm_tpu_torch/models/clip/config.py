"""CLIP architecture hyperparameters (copy of fsvlm_tpu.models.clip.config).

Shape inference from an OpenAI state dict follows the reference exactly
(PromptSRC/clip/model.py:662-687).
"""

import dataclasses
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    # vision
    image_resolution: int
    vision_layers: Union[int, Tuple[int, int, int, int]]  # int => ViT, tuple => ModifiedResNet
    vision_width: int
    vision_patch_size: Optional[int]
    # text
    context_length: int
    vocab_size: int
    transformer_width: int
    transformer_heads: int
    transformer_layers: int

    @property
    def is_vit(self):
        return isinstance(self.vision_layers, int)

    @property
    def vision_heads(self):
        if self.is_vit:
            return self.vision_width // 64
        return self.vision_width * 32 // 64

    @property
    def grid_size(self):
        return self.image_resolution // self.vision_patch_size

    @property
    def vision_seq_len(self):
        return self.grid_size ** 2 + 1


# Published OpenAI architectures (clip/clip.py:29-36 model zoo).
ARCHS = {
    "ViT-B/32": CLIPConfig(512, 224, 12, 768, 32, 77, 49408, 512, 8, 12),
    "ViT-B/16": CLIPConfig(512, 224, 12, 768, 16, 77, 49408, 512, 8, 12),
    "RN50": CLIPConfig(1024, 224, (3, 4, 6, 3), 64, None, 77, 49408, 512, 8, 12),
    "RN101": CLIPConfig(512, 224, (3, 4, 23, 3), 64, None, 77, 49408, 512, 8, 12),
    "RN50x4": CLIPConfig(640, 288, (4, 6, 10, 6), 80, None, 77, 49408, 640, 10, 12),
    "RN50x16": CLIPConfig(768, 384, (6, 8, 18, 8), 96, None, 77, 49408, 768, 12, 12),
    # tiny configs for tests / dryruns (not OpenAI archs)
    "test-tiny": CLIPConfig(64, 32, 2, 64, 16, 77, 49408, 64, 2, 2),
    "test-tiny-rn": CLIPConfig(128, 64, (1, 1, 1, 1), 16, None, 77, 49408, 64, 2, 2),
}


def config_from_state_dict_shapes(sd):
    """Infer the architecture from tensor shapes (clip/model.py:663-687)."""
    vit = "visual.proj" in sd

    if vit:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len(
            [k for k in sd if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")]
        )
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        grid_size = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid_size
    else:
        counts = [
            len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
            for b in [1, 2, 3, 4]
        ]
        vision_layers = tuple(counts)
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        output_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision_patch_size = None
        image_resolution = output_width * 32

    embed_dim = sd["text_projection"].shape[1]
    context_length = sd["positional_embedding"].shape[0]
    vocab_size = sd["token_embedding.weight"].shape[0]
    transformer_width = sd["ln_final.weight"].shape[0]
    transformer_heads = transformer_width // 64
    transformer_layers = len(
        {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")}
    )

    return CLIPConfig(
        embed_dim=embed_dim,
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=context_length,
        vocab_size=vocab_size,
        transformer_width=transformer_width,
        transformer_heads=transformer_heads,
        transformer_layers=transformer_layers,
    )
