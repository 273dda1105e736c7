"""The port's W-sharding helpers without a model axis: each is the plain op."""
import torch.nn.functional as F


def halo(kernel, stride, padding, dilation=1):
    return padding, max(0, dilation * (kernel - 1) - padding - (stride - 1))


def check_columns(width, stride, axis):
    if axis is not None:
        raise ValueError('the reference runs in one process, without a model axis')


def shard_w(x, axis):
    return x


def halo_pad(x, left, right, axis, value=0.0):
    return x


def conv2d(conv, x, axis, padded=False):
    return conv(x)


def max_pool2d(x, kernel, stride, padding, axis):
    return F.max_pool2d(x, kernel, stride, padding)
