"""``paddle_tpu_torch.vision.models``: the names of
``paddle_tpu/vision/models.py:1-21`` (reference: python/paddle/vision/
models), from the port's ``models``."""
from ..models.lenet import LeNet  # noqa: F401
from ..models.resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext50_64x4d,
    resnext101_32x4d, resnext101_64x4d, resnext152_32x4d,
    resnext152_64x4d, wide_resnet50_2, wide_resnet101_2,
)
from ..models.vision_zoo import (  # noqa: F401
    AlexNet, MobileNetV1, MobileNetV2, VGG, alexnet, vgg11, vgg13, vgg16,
    vgg19,
)
from ..models.vision_zoo2 import (  # noqa: F401
    DenseNet, GoogLeNet, InceptionV3, MobileNetV3Large, MobileNetV3Small,
    ShuffleNetV2, SqueezeNet, densenet121, densenet161, densenet169,
    densenet201, densenet264, googlenet, inception_v3, mobilenet_v1,
    mobilenet_v2, mobilenet_v3_large, mobilenet_v3_small,
    shufflenet_v2_swish, shufflenet_v2_x0_5, shufflenet_v2_x0_25,
    shufflenet_v2_x0_33, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, squeezenet1_0, squeezenet1_1,
)
