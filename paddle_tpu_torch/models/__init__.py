"""Models of the port (``paddle_tpu/models``)."""
from .bert import (BertConfig, BertForMaskedLM, BertForSequenceClassification,
                   BertModel, bert_base, bert_tiny)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion, gpt_13b, gpt_1p3b, gpt_small,
                  gpt_tiny)
from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)
from .seq2seq import Seq2SeqTransformer
from .vision_zoo import (VGG, AlexNet, MobileNetV1, MobileNetV2, alexnet,
                         vgg11, vgg13, vgg16, vgg19)
from .vision_zoo2 import (DenseNet, GoogLeNet, InceptionV3, MobileNetV3Large,
                          MobileNetV3Small, ShuffleNetV2, SqueezeNet,
                          densenet121, densenet161, densenet169, densenet201,
                          densenet264, googlenet, inception_v3, mobilenet_v1,
                          mobilenet_v2, mobilenet_v3_large,
                          mobilenet_v3_small, shufflenet_v2_swish,
                          shufflenet_v2_x0_5, shufflenet_v2_x0_25,
                          shufflenet_v2_x0_33, shufflenet_v2_x1_0,
                          shufflenet_v2_x1_5, shufflenet_v2_x2_0,
                          squeezenet1_0, squeezenet1_1)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt_small", "gpt_1p3b",
           "gpt_13b", "LeNet", "BasicBlock", "BottleneckBlock", "ResNet",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
           "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
           "resnext152_32x4d", "resnext152_64x4d", "BertConfig", "BertModel",
           "BertForSequenceClassification", "BertForMaskedLM", "bert_base",
           "bert_tiny", "Seq2SeqTransformer", "VGG", "vgg11", "vgg13",
           "vgg16", "vgg19", "MobileNetV1", "MobileNetV2", "AlexNet",
           "alexnet", "DenseNet", "densenet121", "densenet161",
           "densenet169", "densenet201", "densenet264", "GoogLeNet",
           "googlenet", "InceptionV3", "inception_v3", "MobileNetV3Large",
           "MobileNetV3Small", "mobilenet_v3_large", "mobilenet_v3_small",
           "mobilenet_v1", "mobilenet_v2", "ShuffleNetV2",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish", "SqueezeNet",
           "squeezenet1_0", "squeezenet1_1"]
