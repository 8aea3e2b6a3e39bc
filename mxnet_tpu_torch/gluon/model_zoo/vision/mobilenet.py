"""Gluon MobileNet v1 (capability twin of the reference's
example/image-classification/symbols/mobilenet.py, in gluon form —
depthwise-separable convs map to grouped convolutions)."""
from ._pretrained import finish_pretrained
from ...block import HybridBlock
from ... import nn

__all__ = ["MobileNet", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25"]


def _add_conv(out, channels, kernel=1, stride=1, pad=0, num_group=1):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels)
    _add_conv(out, channels)


class MobileNet(HybridBlock):
    """(reference capability: symbols/mobilenet.py get_symbol)."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1)
                dw_channels = [int(x * multiplier) for x in
                               [32, 64] + [128] * 2 + [256] * 2 +
                               [512] * 6 + [1024]]
                channels = [int(x * multiplier) for x in
                            [64] + [128] * 2 + [256] * 2 + [512] * 6 +
                            [1024] * 2]
                strides = [1, 2] * 3 + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    _add_conv_dw(self.features, dwc, c, s)
                self.features.add(nn.GlobalAvgPool2D())
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


def mobilenet1_0(pretrained=False, **kwargs):
    return finish_pretrained(MobileNet(1.0, **kwargs), pretrained)


def mobilenet0_75(pretrained=False, **kwargs):
    return finish_pretrained(MobileNet(0.75, **kwargs), pretrained)


def mobilenet0_5(pretrained=False, **kwargs):
    return finish_pretrained(MobileNet(0.5, **kwargs), pretrained)


def mobilenet0_25(pretrained=False, **kwargs):
    return finish_pretrained(MobileNet(0.25, **kwargs), pretrained)
