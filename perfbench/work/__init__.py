"""Operation and byte counts from the model's shapes and the data (never
from the port's launch shapes), and the card's published peaks."""
