"""Vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): the ResNets.  The other
families (AlexNet, DenseNet, Inception, MobileNet, SqueezeNet, VGG) are
not ported yet."""
from .resnet import (resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,  # noqa: F401
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
                     resnet101_v2, resnet152_v2, get_resnet, ResNetV1,
                     ResNetV2)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """A model by name (reference: vision/__init__.py get_model)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            "Model %s is not supported. Available options are\n\t%s" % (
                name, "\n\t".join(sorted(_models.keys()))))
    return _models[name](**kwargs)
