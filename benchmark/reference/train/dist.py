"""One process, no group: the minibatch-std layer's gather is the batch
itself."""


def rank():
    return 0


def all_gather_batch(x):
    return x
