"""The port's process-group layer reduced to one process: no group, every
sum over the ranks is the value itself."""


def active() -> bool:
    return False


def model_axis():
    return None


def all_reduce_sum(x):
    return x


def once(x):
    return x


def process_count() -> int:
    return 1


def process_index() -> int:
    return 0
