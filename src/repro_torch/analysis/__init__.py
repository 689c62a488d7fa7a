"""Analysis of a step: the cost counter (the port's counterpart of the
reference's while-aware HLO parser), the roofline report on the H100, and
the profile by site.

cost      a ``TorchDispatchMode`` that counts every aten operation's
          FLOPs and bytes, and the hand-written kernels' counted work
roofline  compute, memory and collective terms on the H100 SXM;
          ``model_flops``, the memory term from a characterized CurveDB
profile   the counted bytes and flops by the port's source line
"""
