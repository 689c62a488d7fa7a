"""Runtime fault tolerance: the straggler monitor and the resilient
train loop."""
