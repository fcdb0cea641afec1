"""CUDA events recorded around each step's call into the batch
augmentation (the bake included), summed, over the steps."""


def read(raw):
    if raw["unit"] != "train_step" or not raw["augment_ms"]:
        return None
    return sum(raw["augment_ms"]) / len(raw["augment_ms"])
