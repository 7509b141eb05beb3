from .meters import AverageMeter, MetricWriter

__all__ = ["AverageMeter", "MetricWriter"]
