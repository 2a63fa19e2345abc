from of_spmm.models.gcn import GCN, normalized_adjacency
from of_spmm.models.sage import GraphSAGE, mean_adjacency
from of_spmm.models.embedding import Embedding
from of_spmm.models.gat import GAT
from of_spmm.models.sharded_embedding import ShardedEmbedding
from of_spmm.models.resnet import ResNet, resnet50, resnet101
from of_spmm.models.transformer import TransformerEncoder, bert_base, bert_tiny
from of_spmm.models.vision import VGG16, AlexNet, vgg16, alexnet

__all__ = [
    "GCN",
    "normalized_adjacency",
    "GraphSAGE",
    "mean_adjacency",
    "Embedding",
    "GAT",
    "ShardedEmbedding",
    "ResNet",
    "resnet50",
    "resnet101",
    "TransformerEncoder",
    "bert_base",
    "bert_tiny",
    "VGG16",
    "AlexNet",
    "vgg16",
    "alexnet",
]
