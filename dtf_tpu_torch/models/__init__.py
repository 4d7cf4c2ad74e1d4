"""Model families: ResNet-50, the CIFAR ResNets, the trivial probe, the
transformer LM, and their registry."""
