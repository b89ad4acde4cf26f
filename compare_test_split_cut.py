"""chip_smoke.py phase 12 on the Caltech101-layout tree with the tree's full
test split (Caltech101's 24-25 a class, 2465 images) and with the cut one
(RECOG_TEST_PER_CLASS a class), in turns (full, cut, cut, full), in one
process on one card: each run's seconds, which is what the cut saves in
phase 12 (phases 13-16 evaluate the same split and save more).  On a card:

    python3 compare_test_split_cut.py
"""

import json
import os

import chip_smoke as c


def full_tree(root, fixtures):
    """``chip_smoke._caltech_tree`` at Caltech101's test sizes."""
    image_dir = os.path.join(root, "caltech-101", "101_ObjectCategories")
    split = {"train": [], "val": [], "test": []}
    pairs, k = [], 0
    for cls in range(c.RECOG_CLASSES):
        cname = f"category_{cls:03d}"
        for part, n in {"train": 41, "val": 17 if cls < 50 else 16,
                        "test": 25 if cls < 65 else 24}.items():
            for j in range(n):
                rel = f"{cname}/image_{part}_{j:04d}.jpg"
                pairs.append((os.path.abspath(os.path.join(c.FIXTURE_DIR,
                                                           fixtures[k % len(fixtures)])),
                              os.path.join(image_dir, rel)))
                split[part].append([rel, cls, cname.replace("_", " ")])
                k += 1
    c._link_all(pairs)
    with open(os.path.join(root, "caltech-101", "split_zhou_Caltech101.json"), "w") as f:
        json.dump(split, f)
    return {part: len(v) for part, v in split.items()}


def main():
    from fsvlm_tpu_torch.trainers.backbone import load_clip_backbone

    c.phase_device()
    c.phase_build()
    clip = load_clip_backbone("ViT-B/16", False, "bf16", 0, "cuda")
    cut_tree = c._caltech_tree
    seconds = []
    for label, tree in (("full", full_tree), ("cut", cut_tree), ("cut", cut_tree),
                        ("full", full_tree)):
        c._caltech_tree = tree
        with c.force_pallas(None):
            c.phase_recognition(clip)
        seconds.append((label, c.PHASE_S["phase_recognition"]))
        print(f"phase 12 with the {label} test split: {seconds[-1][1]} s", flush=True)
    print(json.dumps({"phase_12_seconds_in_turns": seconds}))


if __name__ == "__main__":
    main()
