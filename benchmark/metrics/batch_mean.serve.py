"""batch_mean.serve: images per dispatched batch over the window, from the
engine's own counters (stats["images"] / stats["batches"])."""


def read(data):
    if not data.get("batches"):
        return None
    return data["batch_images"] / data["batches"]
