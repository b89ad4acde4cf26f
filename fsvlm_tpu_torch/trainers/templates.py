"""Prompt templates (the port's own copy of fsvlm_tpu.trainers.templates'
CUSTOM_TEMPLATES, :10-27, the reference's trainers/zsclip.py per-dataset
templates, and IMAGENET_TEMPLATES_SELECT, :29-40, the 7-template ensembling
subset; public OpenAI CLIP data).  IVLP's KD teacher and ZeroshotCLIP read
DATASET.NAME's template; ZeroshotCLIP2 ensembles the select set with it.
"""

CUSTOM_TEMPLATES = {
    "OxfordPets": "a photo of a {}, a type of pet.",
    "OxfordFlowers": "a photo of a {}, a type of flower.",
    "FGVCAircraft": "a photo of a {}, a type of aircraft.",
    "DescribableTextures": "{} texture.",
    "EuroSAT": "a centered satellite photo of {}.",
    "StanfordCars": "a photo of a {}.",
    "Food101": "a photo of {}, a type of food.",
    "SUN397": "a photo of a {}.",
    "Caltech101": "a photo of a {}.",
    "UCF101": "a photo of a person doing {}.",
    "ImageNet": "a photo of a {}.",
    "ImageNetSketch": "a photo of a {}.",
    "ImageNetV2": "a photo of a {}.",
    "ImageNetA": "a photo of a {}.",
    "ImageNetR": "a photo of a {}.",
    "Synthetic": "a photo of a {}.",
}

# the 7-template ensembling subset (imagenet_templates.py IMAGENET_TEMPLATES_SELECT)
IMAGENET_TEMPLATES_SELECT = [
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
]
