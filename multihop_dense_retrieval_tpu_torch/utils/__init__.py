from .docdb import DocDB
from .meters import AverageMeter, MetricWriter
from .text import SimpleTokenizer, para_has_answer

__all__ = ["AverageMeter", "DocDB", "MetricWriter", "SimpleTokenizer",
           "para_has_answer"]
