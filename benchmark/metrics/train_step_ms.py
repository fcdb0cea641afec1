"""The window's milliseconds over the steps finished in it (host clock;
the window ends with a synchronisation after its last step)."""


def read(raw):
    if raw["unit"] != "train_step":
        return None
    return 1e3 * raw["window_s"] / raw["steps"]
