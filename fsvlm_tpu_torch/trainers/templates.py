"""Per-dataset prompt templates (the port's own copy of
fsvlm_tpu.trainers.templates.CUSTOM_TEMPLATES, :10-27: the reference's
trainers/zsclip.py CUSTOM_TEMPLATES, public OpenAI CLIP data).  IVLP's KD
teacher reads its text features through DATASET.NAME's template.
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
