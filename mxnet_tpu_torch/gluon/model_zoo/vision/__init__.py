"""Vision model zoo.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/__init__.py`` (reference
``python/mxnet/gluon/model_zoo/vision/__init__.py``): every family, the
``_models`` table and ``get_model`` under the JAX package's names.
``pretrained=True`` loads ``.params`` files that
``model_zoo.model_store.get_model_file`` resolves under ``root=`` (local
files with an optional sha256 sidecar; nothing is downloaded)."""
from .alexnet import alexnet, AlexNet  # noqa: F401
from .densenet import (densenet121, densenet161, densenet169, densenet201,  # noqa: F401
                       DenseNet)
from .inception import inception_v3, Inception3  # noqa: F401
from .mobilenet import (mobilenet1_0, mobilenet0_75, mobilenet0_5,  # noqa: F401
                        mobilenet0_25, mobilenet_v2_1_0, mobilenet_v2_0_75,
                        mobilenet_v2_0_5, mobilenet_v2_0_25, MobileNet,
                        MobileNetV2)
from .resnet import (resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,  # noqa: F401
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
                     resnet101_v2, resnet152_v2, get_resnet, ResNetV1,
                     ResNetV2)
from .squeezenet import squeezenet1_0, squeezenet1_1, SqueezeNet  # noqa: F401
from .vgg import (vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn, vgg16_bn,  # noqa: F401
                  vgg19_bn, get_vgg, VGG)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn, "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
}


def get_model(name, **kwargs):
    """A model by name (reference: vision/__init__.py get_model)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            "Model %s is not supported. Available options are\n\t%s" % (
                name, "\n\t".join(sorted(_models.keys()))))
    return _models[name](**kwargs)
