"""The yardstick's arithmetic: the card's published peaks, a step's model
FLOPs counted from the shapes the configuration runs, and each kernel's
least time from the operations and bytes its inputs need."""
