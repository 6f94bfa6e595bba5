"""The yardstick's arithmetic: the card's published peaks and, per kernel
family, the least bytes and operations that the work of a launch needs,
counted from its shapes alone (each input byte read once, each output byte
written once), whatever kernel implements it."""
