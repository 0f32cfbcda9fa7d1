"""The yardstick's arithmetic: statistics, peaks and roofline bounds,
FLOP counting, trace reduction and the correctness comparison."""
