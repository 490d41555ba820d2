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

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt_small", "gpt_1p3b",
           "gpt_13b", "LeNet", "BasicBlock", "BottleneckBlock", "ResNet",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
           "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
           "resnext152_32x4d", "resnext152_64x4d", "BertConfig", "BertModel",
           "BertForSequenceClassification", "BertForMaskedLM", "bert_base",
           "bert_tiny", "Seq2SeqTransformer"]
