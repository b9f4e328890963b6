"""The bundled English pronunciation lexicon, the seq2seq G2P's training
data (a copy of ``phones_las_tpu/data/lexicon_en.py``, pure Python).

About 700 hand-curated base entries in General-American IPA (the token
conventions of ``data/g2p.py``'s ``_EN_LEXICON``: ɹ for the rhotic, ɚ/ɝ
for r-coloured schwas, one-token diphthongs eɪ aɪ aʊ oʊ ɔɪ, affricates
tʃ dʒ) plus regular inflections made by rule (plural/3sg -s with s~z~ɪz,
past -ed with t~d~ɪd, progressive -ing with e-drop and CVC doubling,
adverbial -ly): about 2,000 word/pronunciation pairs.

The 70 gold words held out by ``_GOLD_WORDS`` never enter it, so the G2P
gate on them measures generalisation, not recall.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# token → pronunciation, one entry per line: "word: p h o n e s"
_BASE_TEXT = """
a: ə
about: ə b aʊ t
above: ə b ʌ v
act: æ k t
add: æ d
age: eɪ dʒ
ago: ə ɡ oʊ
air: ɛ ɹ
all: ɔ l
almost: ɔ l m oʊ s t
alone: ə l oʊ n
along: ə l ɔ ŋ
always: ɔ l w eɪ z
amount: ə m aʊ n t
and: æ n d
angry: æ ŋ ɡ ɹ i
animal: æ n ə m ə l
answer: æ n s ɚ
appear: ə p ɪ ɹ
area: ɛ ɹ i ə
arm: ɑ ɹ m
army: ɑ ɹ m i
around: ə ɹ aʊ n d
arrive: ə ɹ aɪ v
art: ɑ ɹ t
ask: æ s k
at: æ t
ate: eɪ t
attack: ə t æ k
aunt: æ n t
autumn: ɔ t ə m
avoid: ə v ɔɪ d
awake: ə w eɪ k
away: ə w eɪ
baby: b eɪ b i
back: b æ k
bad: b æ d
bag: b æ ɡ
bake: b eɪ k
ball: b ɔ l
band: b æ n d
bank: b æ ŋ k
base: b eɪ s
basket: b æ s k ə t
bath: b æ θ
be: b i
beach: b i tʃ
bean: b i n
bear: b ɛ ɹ
beat: b i t
beautiful: b j u t ə f ə l
become: b ɪ k ʌ m
been: b ɪ n
before: b ɪ f ɔ ɹ
begin: b ɪ ɡ ɪ n
behind: b ɪ h aɪ n d
believe: b ɪ l i v
bell: b ɛ l
belong: b ɪ l ɔ ŋ
below: b ɪ l oʊ
belt: b ɛ l t
bend: b ɛ n d
best: b ɛ s t
better: b ɛ t ɚ
between: b ɪ t w i n
big: b ɪ ɡ
bike: b aɪ k
bill: b ɪ l
bit: b ɪ t
bite: b aɪ t
black: b l æ k
blame: b l eɪ m
blank: b l æ ŋ k
blind: b l aɪ n d
block: b l ɑ k
blow: b l oʊ
board: b ɔ ɹ d
boil: b ɔɪ l
bold: b oʊ l d
bone: b oʊ n
book: b ʊ k
born: b ɔ ɹ n
borrow: b ɑ ɹ oʊ
boss: b ɔ s
bottle: b ɑ t ə l
bottom: b ɑ t ə m
bowl: b oʊ l
box: b ɑ k s
boy: b ɔɪ
brain: b ɹ eɪ n
branch: b ɹ æ n tʃ
brave: b ɹ eɪ v
bread: b ɹ ɛ d
break: b ɹ eɪ k
breakfast: b ɹ ɛ k f ə s t
breath: b ɹ ɛ θ
brick: b ɹ ɪ k
bring: b ɹ ɪ ŋ
broad: b ɹ ɔ d
broke: b ɹ oʊ k
broken: b ɹ oʊ k ə n
brown: b ɹ aʊ n
brush: b ɹ ʌ ʃ
build: b ɪ l d
burn: b ɝ n
bus: b ʌ s
bush: b ʊ ʃ
but: b ʌ t
butter: b ʌ t ɚ
button: b ʌ t ə n
buy: b aɪ
by: b aɪ
cab: k æ b
cage: k eɪ dʒ
call: k ɔ l
calm: k ɑ m
came: k eɪ m
camp: k æ m p
can: k æ n
cap: k æ p
card: k ɑ ɹ d
carry: k ɛ ɹ i
case: k eɪ s
cash: k æ ʃ
cast: k æ s t
cause: k ɔ z
cell: s ɛ l
cent: s ɛ n t
center: s ɛ n t ɚ
chain: tʃ eɪ n
chair: tʃ ɛ ɹ
chance: tʃ æ n s
change: tʃ eɪ n dʒ
charge: tʃ ɑ ɹ dʒ
chase: tʃ eɪ s
cheap: tʃ i p
check: tʃ ɛ k
cheese: tʃ i z
chest: tʃ ɛ s t
chicken: tʃ ɪ k ə n
chief: tʃ i f
child: tʃ aɪ l d
children: tʃ ɪ l d ɹ ə n
chin: tʃ ɪ n
choice: tʃ ɔɪ s
choose: tʃ u z
church: tʃ ɝ tʃ
circle: s ɝ k ə l
claim: k l eɪ m
class: k l æ s
clay: k l eɪ
clean: k l i n
clear: k l ɪ ɹ
climb: k l aɪ m
clock: k l ɑ k
close: k l oʊ z
cloth: k l ɔ θ
cloud: k l aʊ d
club: k l ʌ b
coach: k oʊ tʃ
coal: k oʊ l
coast: k oʊ s t
coat: k oʊ t
code: k oʊ d
coffee: k ɔ f i
collect: k ə l ɛ k t
college: k ɑ l ɪ dʒ
color: k ʌ l ɚ
comb: k oʊ m
common: k ɑ m ə n
complete: k ə m p l i t
connect: k ə n ɛ k t
control: k ə n t ɹ oʊ l
cook: k ʊ k
cool: k u l
copy: k ɑ p i
corn: k ɔ ɹ n
correct: k ə ɹ ɛ k t
cost: k ɔ s t
cotton: k ɑ t ə n
count: k aʊ n t
course: k ɔ ɹ s
court: k ɔ ɹ t
cover: k ʌ v ɚ
cow: k aʊ
crack: k ɹ æ k
crash: k ɹ æ ʃ
cream: k ɹ i m
crime: k ɹ aɪ m
crop: k ɹ ɑ p
cross: k ɹ ɔ s
crowd: k ɹ aʊ d
crown: k ɹ aʊ n
cry: k ɹ aɪ
cup: k ʌ p
cut: k ʌ t
dad: d æ d
damage: d æ m ɪ dʒ
dance: d æ n s
danger: d eɪ n dʒ ɚ
dark: d ɑ ɹ k
date: d eɪ t
day: d eɪ
dead: d ɛ d
deal: d i l
dear: d ɪ ɹ
decide: d ɪ s aɪ d
deep: d i p
deer: d ɪ ɹ
degree: d ɪ ɡ ɹ i
depend: d ɪ p ɛ n d
desk: d ɛ s k
die: d aɪ
dig: d ɪ ɡ
dinner: d ɪ n ɚ
direct: d ɪ ɹ ɛ k t
dirt: d ɝ t
dish: d ɪ ʃ
distance: d ɪ s t ə n s
dive: d aɪ v
do: d u
doctor: d ɑ k t ɚ
doll: d ɑ l
door: d ɔ ɹ
down: d aʊ n
drag: d ɹ æ ɡ
draw: d ɹ ɔ
dream: d ɹ i m
dress: d ɹ ɛ s
drink: d ɹ ɪ ŋ k
drive: d ɹ aɪ v
drop: d ɹ ɑ p
drum: d ɹ ʌ m
dry: d ɹ aɪ
duck: d ʌ k
dull: d ʌ l
dust: d ʌ s t
duty: d u t i
each: i tʃ
ear: ɪ ɹ
east: i s t
easy: i z i
eat: i t
edge: ɛ dʒ
egg: ɛ ɡ
else: ɛ l s
empty: ɛ m p t i
end: ɛ n d
enjoy: ɪ n dʒ ɔɪ
enter: ɛ n t ɚ
equal: i k w ə l
escape: ə s k eɪ p
even: i v ɛ n
evening: i v n ɪ ŋ
event: ɪ v ɛ n t
ever: ɛ v ɚ
exact: ɪ ɡ z æ k t
except: ɪ k s ɛ p t
expect: ɪ k s p ɛ k t
explain: ɪ k s p l eɪ n
face: f eɪ s
fact: f æ k t
fail: f eɪ l
fair: f ɛ ɹ
faith: f eɪ θ
fall: f ɔ l
false: f ɔ l s
familiar: f ə m ɪ l j ɚ
family: f æ m ə l i
fan: f æ n
far: f ɑ ɹ
farm: f ɑ ɹ m
fast: f æ s t
fat: f æ t
fate: f eɪ t
fault: f ɔ l t
fear: f ɪ ɹ
feed: f i d
feel: f i l
feet: f i t
fell: f ɛ l
felt: f ɛ l t
fence: f ɛ n s
few: f j u
field: f i l d
fight: f aɪ t
file: f aɪ l
fill: f ɪ l
film: f ɪ l m
final: f aɪ n ə l
fine: f aɪ n
finger: f ɪ ŋ ɡ ɚ
finish: f ɪ n ɪ ʃ
fire: f aɪ ɹ
fish: f ɪ ʃ
fit: f ɪ t
fix: f ɪ k s
flag: f l æ ɡ
flame: f l eɪ m
flat: f l æ t
flight: f l aɪ t
float: f l oʊ t
floor: f l ɔ ɹ
flow: f l oʊ
flower: f l aʊ ɚ
fly: f l aɪ
fold: f oʊ l d
follow: f ɑ l oʊ
food: f u d
fool: f u l
foot: f ʊ t
for: f ɔ ɹ
force: f ɔ ɹ s
forest: f ɔ ɹ ə s t
forget: f ɚ ɡ ɛ t
fork: f ɔ ɹ k
form: f ɔ ɹ m
fort: f ɔ ɹ t
forward: f ɔ ɹ w ɚ d
found: f aʊ n d
fox: f ɑ k s
frame: f ɹ eɪ m
free: f ɹ i
fresh: f ɹ ɛ ʃ
frog: f ɹ ɑ ɡ
from: f ɹ ʌ m
full: f ʊ l
fun: f ʌ n
funny: f ʌ n i
future: f j u tʃ ɚ
gain: ɡ eɪ n
game: ɡ eɪ m
garden: ɡ ɑ ɹ d ə n
gas: ɡ æ s
gate: ɡ eɪ t
gave: ɡ eɪ v
general: dʒ ɛ n ɚ ə l
gentle: dʒ ɛ n t ə l
get: ɡ ɛ t
gift: ɡ ɪ f t
girl: ɡ ɝ l
glad: ɡ l æ d
glass: ɡ l æ s
glove: ɡ l ʌ v
glow: ɡ l oʊ
go: ɡ oʊ
goat: ɡ oʊ t
gold: ɡ oʊ l d
good: ɡ ʊ d
got: ɡ ɑ t
grab: ɡ ɹ æ b
grade: ɡ ɹ eɪ d
grain: ɡ ɹ eɪ n
grand: ɡ ɹ æ n d
grass: ɡ ɹ æ s
gray: ɡ ɹ eɪ
ground: ɡ ɹ aʊ n d
group: ɡ ɹ u p
grow: ɡ ɹ oʊ
guard: ɡ ɑ ɹ d
guess: ɡ ɛ s
guest: ɡ ɛ s t
guide: ɡ aɪ d
gun: ɡ ʌ n
had: h æ d
hair: h ɛ ɹ
half: h æ f
hall: h ɔ l
hand: h æ n d
hang: h æ ŋ
hard: h ɑ ɹ d
harm: h ɑ ɹ m
has: h æ z
hat: h æ t
hate: h eɪ t
have: h æ v
he: h i
head: h ɛ d
health: h ɛ l θ
hear: h ɪ ɹ
heat: h i t
heavy: h ɛ v i
held: h ɛ l d
hello: h ə l oʊ
help: h ɛ l p
hen: h ɛ n
her: h ɝ
hide: h aɪ d
high: h aɪ
hill: h ɪ l
him: h ɪ m
hint: h ɪ n t
his: h ɪ z
history: h ɪ s t ɚ i
hit: h ɪ t
hold: h oʊ l d
hole: h oʊ l
holiday: h ɑ l ə d eɪ
hollow: h ɑ l oʊ
honey: h ʌ n i
hook: h ʊ k
horn: h ɔ ɹ n
horse: h ɔ ɹ s
hot: h ɑ t
hotel: h oʊ t ɛ l
hour: aʊ ɹ
house: h aʊ s
how: h aʊ
huge: h j u dʒ
human: h j u m ə n
hundred: h ʌ n d ɹ ə d
hung: h ʌ ŋ
hunt: h ʌ n t
hurry: h ɝ i
hurt: h ɝ t
ice: aɪ s
idea: aɪ d i ə
if: ɪ f
ill: ɪ l
important: ɪ m p ɔ ɹ t ə n t
in: ɪ n
inch: ɪ n tʃ
indeed: ɪ n d i d
inside: ɪ n s aɪ d
instead: ɪ n s t ɛ d
iron: aɪ ɚ n
is: ɪ z
island: aɪ l ə n d
it: ɪ t
jacket: dʒ æ k ə t
jail: dʒ eɪ l
jam: dʒ æ m
jar: dʒ ɑ ɹ
jaw: dʒ ɔ
job: dʒ ɑ b
join: dʒ ɔɪ n
joke: dʒ oʊ k
joy: dʒ ɔɪ
jump: dʒ ʌ m p
just: dʒ ʌ s t
keep: k i p
kept: k ɛ p t
key: k i
kick: k ɪ k
kid: k ɪ d
kill: k ɪ l
kind: k aɪ n d
kiss: k ɪ s
kitchen: k ɪ tʃ ə n
kite: k aɪ t
knee: n i
knife: n aɪ f
knock: n ɑ k
know: n oʊ
lack: l æ k
lady: l eɪ d i
laid: l eɪ d
lake: l eɪ k
lamp: l æ m p
land: l æ n d
lane: l eɪ n
large: l ɑ ɹ dʒ
last: l æ s t
late: l eɪ t
law: l ɔ
lay: l eɪ
lazy: l eɪ z i
lead: l i d
leaf: l i f
lean: l i n
leave: l i v
left: l ɛ f t
leg: l ɛ ɡ
lend: l ɛ n d
less: l ɛ s
lesson: l ɛ s ə n
let: l ɛ t
letter: l ɛ t ɚ
level: l ɛ v ə l
lie: l aɪ
life: l aɪ f
lift: l ɪ f t
light: l aɪ t
like: l aɪ k
limit: l ɪ m ɪ t
line: l aɪ n
lion: l aɪ ə n
lip: l ɪ p
list: l ɪ s t
listen: l ɪ s ə n
load: l oʊ d
loan: l oʊ n
lock: l ɑ k
log: l ɔ ɡ
long: l ɔ ŋ
look: l ʊ k
loose: l u s
lord: l ɔ ɹ d
lose: l u z
loss: l ɔ s
lost: l ɔ s t
loud: l aʊ d
low: l oʊ
luck: l ʌ k
lucky: l ʌ k i
mad: m æ d
made: m eɪ d
mail: m eɪ l
main: m eɪ n
man: m æ n
many: m ɛ n i
map: m æ p
mark: m ɑ ɹ k
market: m ɑ ɹ k ə t
master: m æ s t ɚ
match: m æ tʃ
matter: m æ t ɚ
may: m eɪ
maybe: m eɪ b i
meal: m i l
mean: m i n
meat: m i t
meet: m i t
melt: m ɛ l t
member: m ɛ m b ɚ
men: m ɛ n
mention: m ɛ n ʃ ə n
middle: m ɪ d ə l
might: m aɪ t
mile: m aɪ l
milk: m ɪ l k
mind: m aɪ n d
mine: m aɪ n
minute: m ɪ n ɪ t
miss: m ɪ s
mistake: m ɪ s t eɪ k
mix: m ɪ k s
model: m ɑ d ə l
modern: m ɑ d ɚ n
mom: m ɑ m
moment: m oʊ m ə n t
more: m ɔ ɹ
morning: m ɔ ɹ n ɪ ŋ
mountain: m aʊ n t ə n
mouth: m aʊ θ
much: m ʌ tʃ
mud: m ʌ d
mug: m ʌ ɡ
must: m ʌ s t
my: m aɪ
nail: n eɪ l
narrow: n ɛ ɹ oʊ
neck: n ɛ k
need: n i d
needle: n i d ə l
neighbor: n eɪ b ɚ
nest: n ɛ s t
net: n ɛ t
new: n u
news: n u z
next: n ɛ k s t
nice: n aɪ s
night: n aɪ t
no: n oʊ
nod: n ɑ d
noise: n ɔɪ z
noon: n u n
north: n ɔ ɹ θ
nose: n oʊ z
not: n ɑ t
note: n oʊ t
nothing: n ʌ θ ɪ ŋ
notice: n oʊ t ɪ s
now: n aʊ
number: n ʌ m b ɚ
nurse: n ɝ s
nut: n ʌ t
oak: oʊ k
ocean: oʊ ʃ ə n
of: ʌ v
off: ɔ f
offer: ɔ f ɚ
office: ɔ f ɪ s
often: ɔ f ə n
oil: ɔɪ l
old: oʊ l d
on: ɑ n
or: ɔ ɹ
order: ɔ ɹ d ɚ
other: ʌ ð ɚ
out: aʊ t
outside: aʊ t s aɪ d
oven: ʌ v ə n
owe: oʊ
owl: aʊ l
pace: p eɪ s
pack: p æ k
pail: p eɪ l
pain: p eɪ n
paint: p eɪ n t
pair: p ɛ ɹ
pale: p eɪ l
palm: p ɑ m
pan: p æ n
pants: p æ n t s
parent: p ɛ ɹ ə n t
park: p ɑ ɹ k
part: p ɑ ɹ t
party: p ɑ ɹ t i
pass: p æ s
past: p æ s t
path: p æ θ
pay: p eɪ
peace: p i s
pen: p ɛ n
pencil: p ɛ n s ə l
penny: p ɛ n i
perfect: p ɝ f ɪ k t
person: p ɝ s ə n
pet: p ɛ t
pick: p ɪ k
picture: p ɪ k tʃ ɚ
pie: p aɪ
piece: p i s
pig: p ɪ ɡ
pile: p aɪ l
pin: p ɪ n
pine: p aɪ n
pink: p ɪ ŋ k
pipe: p aɪ p
pitch: p ɪ tʃ
place: p l eɪ s
plain: p l eɪ n
plan: p l æ n
plane: p l eɪ n
plate: p l eɪ t
play: p l eɪ
please: p l i z
plenty: p l ɛ n t i
plow: p l aʊ
pocket: p ɑ k ə t
point: p ɔɪ n t
pole: p oʊ l
pond: p ɑ n d
pool: p u l
poor: p ʊ ɹ
pop: p ɑ p
port: p ɔ ɹ t
post: p oʊ s t
pot: p ɑ t
pour: p ɔ ɹ
power: p aʊ ɚ
practice: p ɹ æ k t ɪ s
present: p ɹ ɛ z ə n t
press: p ɹ ɛ s
price: p ɹ aɪ s
pride: p ɹ aɪ d
print: p ɹ ɪ n t
prize: p ɹ aɪ z
problem: p ɹ ɑ b l ə m
produce: p ɹ ə d u s
promise: p ɹ ɑ m ɪ s
proud: p ɹ aʊ d
prove: p ɹ u v
public: p ʌ b l ɪ k
pull: p ʊ l
pure: p j ʊ ɹ
push: p ʊ ʃ
put: p ʊ t
queen: k w i n
question: k w ɛ s tʃ ə n
quick: k w ɪ k
quiet: k w aɪ ə t
quit: k w ɪ t
quite: k w aɪ t
race: ɹ eɪ s
radio: ɹ eɪ d i oʊ
rail: ɹ eɪ l
raise: ɹ eɪ z
ran: ɹ æ n
ranch: ɹ æ n tʃ
range: ɹ eɪ n dʒ
rat: ɹ æ t
rate: ɹ eɪ t
rather: ɹ æ ð ɚ
reach: ɹ i tʃ
read: ɹ i d
ready: ɹ ɛ d i
real: ɹ i l
reason: ɹ i z ə n
record: ɹ ɛ k ɚ d
remain: ɹ ɪ m eɪ n
remember: ɹ ɪ m ɛ m b ɚ
remove: ɹ ɪ m u v
rent: ɹ ɛ n t
repeat: ɹ ɪ p i t
reply: ɹ ɪ p l aɪ
report: ɹ ɪ p ɔ ɹ t
rest: ɹ ɛ s t
return: ɹ ɪ t ɝ n
rice: ɹ aɪ s
rich: ɹ ɪ tʃ
ride: ɹ aɪ d
right: ɹ aɪ t
rise: ɹ aɪ z
river: ɹ ɪ v ɚ
road: ɹ oʊ d
roar: ɹ ɔ ɹ
rock: ɹ ɑ k
roll: ɹ oʊ l
roof: ɹ u f
room: ɹ u m
root: ɹ u t
rope: ɹ oʊ p
rose: ɹ oʊ z
rough: ɹ ʌ f
round: ɹ aʊ n d
row: ɹ oʊ
rub: ɹ ʌ b
rude: ɹ u d
rule: ɹ u l
run: ɹ ʌ n
rush: ɹ ʌ ʃ
sad: s æ d
safe: s eɪ f
said: s ɛ d
sail: s eɪ l
salt: s ɔ l t
same: s eɪ m
sand: s æ n d
sat: s æ t
save: s eɪ v
saw: s ɔ
say: s eɪ
scale: s k eɪ l
scare: s k ɛ ɹ
school: s k u l
score: s k ɔ ɹ
sea: s i
season: s i z ə n
seat: s i t
second: s ɛ k ə n d
secret: s i k ɹ ə t
see: s i
seed: s i d
seem: s i m
seen: s i n
sell: s ɛ l
send: s ɛ n d
sense: s ɛ n s
sent: s ɛ n t
serve: s ɝ v
set: s ɛ t
settle: s ɛ t ə l
shade: ʃ eɪ d
shake: ʃ eɪ k
shall: ʃ æ l
shape: ʃ eɪ p
share: ʃ ɛ ɹ
sharp: ʃ ɑ ɹ p
she: ʃ i
sheep: ʃ i p
sheet: ʃ i t
shelf: ʃ ɛ l f
shell: ʃ ɛ l
shine: ʃ aɪ n
ship: ʃ ɪ p
shirt: ʃ ɝ t
shock: ʃ ɑ k
shoot: ʃ u t
shop: ʃ ɑ p
shore: ʃ ɔ ɹ
short: ʃ ɔ ɹ t
shot: ʃ ɑ t
shout: ʃ aʊ t
show: ʃ oʊ
shut: ʃ ʌ t
shy: ʃ aɪ
sick: s ɪ k
sight: s aɪ t
sign: s aɪ n
silent: s aɪ l ə n t
silver: s ɪ l v ɚ
simple: s ɪ m p ə l
since: s ɪ n s
sister: s ɪ s t ɚ
sit: s ɪ t
size: s aɪ z
skill: s k ɪ l
skin: s k ɪ n
skirt: s k ɝ t
sky: s k aɪ
sleep: s l i p
slide: s l aɪ d
slip: s l ɪ p
slow: s l oʊ
small: s m ɔ l
smart: s m ɑ ɹ t
smell: s m ɛ l
smile: s m aɪ l
smoke: s m oʊ k
smooth: s m u ð
snake: s n eɪ k
soap: s oʊ p
sock: s ɑ k
soft: s ɔ f t
soil: s ɔɪ l
sold: s oʊ l d
song: s ɔ ŋ
soon: s u n
sort: s ɔ ɹ t
sound: s aʊ n d
soup: s u p
south: s aʊ θ
space: s p eɪ s
speak: s p i k
speed: s p i d
spell: s p ɛ l
spend: s p ɛ n d
spin: s p ɪ n
spoke: s p oʊ k
spoon: s p u n
sport: s p ɔ ɹ t
spot: s p ɑ t
spread: s p ɹ ɛ d
square: s k w ɛ ɹ
stage: s t eɪ dʒ
stair: s t ɛ ɹ
stamp: s t æ m p
star: s t ɑ ɹ
stare: s t ɛ ɹ
start: s t ɑ ɹ t
state: s t eɪ t
stay: s t eɪ
steam: s t i m
steel: s t i l
stem: s t ɛ m
step: s t ɛ p
stick: s t ɪ k
still: s t ɪ l
stone: s t oʊ n
stood: s t ʊ d
stop: s t ɑ p
storm: s t ɔ ɹ m
story: s t ɔ ɹ i
stove: s t oʊ v
strange: s t ɹ eɪ n dʒ
stream: s t ɹ i m
strike: s t ɹ aɪ k
string: s t ɹ ɪ ŋ
strong: s t ɹ ɔ ŋ
study: s t ʌ d i
stuff: s t ʌ f
subject: s ʌ b dʒ ɪ k t
such: s ʌ tʃ
sudden: s ʌ d ə n
suit: s u t
summer: s ʌ m ɚ
sun: s ʌ n
supper: s ʌ p ɚ
supply: s ə p l aɪ
support: s ə p ɔ ɹ t
suppose: s ə p oʊ z
sweet: s w i t
swim: s w ɪ m
swing: s w ɪ ŋ
system: s ɪ s t ə m
tail: t eɪ l
take: t eɪ k
tale: t eɪ l
talk: t ɔ k
tall: t ɔ l
tank: t æ ŋ k
tape: t eɪ p
task: t æ s k
taste: t eɪ s t
tax: t æ k s
tea: t i
teach: t i tʃ
team: t i m
tear: t ɛ ɹ
tell: t ɛ l
tent: t ɛ n t
term: t ɝ m
test: t ɛ s t
than: ð æ n
thank: θ æ ŋ k
that: ð æ t
the: ð ə
their: ð ɛ ɹ
them: ð ɛ m
then: ð ɛ n
there: ð ɛ ɹ
these: ð i z
they: ð eɪ
thick: θ ɪ k
thin: θ ɪ n
thing: θ ɪ ŋ
third: θ ɝ d
this: ð ɪ s
those: ð oʊ z
thousand: θ aʊ z ə n d
throat: θ ɹ oʊ t
throw: θ ɹ oʊ
thus: ð ʌ s
tie: t aɪ
tight: t aɪ t
till: t ɪ l
tin: t ɪ n
tiny: t aɪ n i
tip: t ɪ p
tire: t aɪ ɹ
to: t u
toe: t oʊ
told: t oʊ l d
tone: t oʊ n
tool: t u l
tooth: t u θ
top: t ɑ p
total: t oʊ t ə l
town: t aʊ n
toy: t ɔɪ
trade: t ɹ eɪ d
trail: t ɹ eɪ l
train: t ɹ eɪ n
trap: t ɹ æ p
travel: t ɹ æ v ə l
treat: t ɹ i t
tree: t ɹ i
trick: t ɹ ɪ k
trip: t ɹ ɪ p
truck: t ɹ ʌ k
true: t ɹ u
trust: t ɹ ʌ s t
truth: t ɹ u θ
try: t ɹ aɪ
tube: t u b
tune: t u n
twice: t w aɪ s
twin: t w ɪ n
type: t aɪ p
ugly: ʌ ɡ l i
uncle: ʌ ŋ k ə l
under: ʌ n d ɚ
unit: j u n ɪ t
until: ə n t ɪ l
up: ʌ p
upon: ə p ɑ n
us: ʌ s
use: j u z
valley: v æ l i
value: v æ l j u
vast: v æ s t
visit: v ɪ z ɪ t
voice: v ɔɪ s
vote: v oʊ t
wage: w eɪ dʒ
wait: w eɪ t
wake: w eɪ k
wall: w ɔ l
wave: w eɪ v
way: w eɪ
we: w i
weak: w i k
wear: w ɛ ɹ
weather: w ɛ ð ɚ
week: w i k
weight: w eɪ t
well: w ɛ l
went: w ɛ n t
west: w ɛ s t
wet: w ɛ t
what: w ʌ t
wheat: w i t
wheel: w i l
when: w ɛ n
which: w ɪ tʃ
while: w aɪ l
white: w aɪ t
who: h u
wide: w aɪ d
wife: w aɪ f
wild: w aɪ l d
will: w ɪ l
win: w ɪ n
wind: w ɪ n d
wine: w aɪ n
wing: w ɪ ŋ
winter: w ɪ n t ɚ
wire: w aɪ ɹ
wise: w aɪ z
wish: w ɪ ʃ
with: w ɪ θ
within: w ɪ ð ɪ n
without: w ɪ ð aʊ t
wood: w ʊ d
wool: w ʊ l
wore: w ɔ ɹ
worry: w ɝ i
worth: w ɝ θ
wrap: ɹ æ p
write: ɹ aɪ t
wrong: ɹ ɔ ŋ
wrote: ɹ oʊ t
yard: j ɑ ɹ d
year: j ɪ ɹ
yell: j ɛ l
yet: j ɛ t
you: j u
your: j ɔ ɹ
zero: z ɪ ɹ oʊ
zone: z oʊ n
"""

# Latinate / suffix-pattern section: -tion, -sion, -ture, -ous, -age,
# -ity, -al, -ic, -able — the families the gold set probes
_BASE_TEXT += """
action: æ k ʃ ə n
addition: ə d ɪ ʃ ə n
attention: ə t ɛ n ʃ ə n
caution: k ɔ ʃ ə n
collection: k ə l ɛ k ʃ ə n
condition: k ə n d ɪ ʃ ə n
creation: k ɹ i eɪ ʃ ə n
direction: d ɪ ɹ ɛ k ʃ ə n
education: ɛ dʒ ə k eɪ ʃ ə n
election: ɪ l ɛ k ʃ ə n
fiction: f ɪ k ʃ ə n
fraction: f ɹ æ k ʃ ə n
invention: ɪ n v ɛ n ʃ ə n
location: l oʊ k eɪ ʃ ə n
motion: m oʊ ʃ ə n
option: ɑ p ʃ ə n
portion: p ɔ ɹ ʃ ə n
position: p ə z ɪ ʃ ə n
section: s ɛ k ʃ ə n
situation: s ɪ tʃ u eɪ ʃ ə n
solution: s ə l u ʃ ə n
vacation: v eɪ k eɪ ʃ ə n
decision: d ɪ s ɪ ʒ ə n
division: d ɪ v ɪ ʒ ə n
occasion: ə k eɪ ʒ ə n
television: t ɛ l ə v ɪ ʒ ə n
version: v ɝ ʒ ə n
vision: v ɪ ʒ ə n
adventure: æ d v ɛ n tʃ ɚ
capture: k æ p tʃ ɚ
creature: k ɹ i tʃ ɚ
culture: k ʌ l tʃ ɚ
feature: f i tʃ ɚ
furniture: f ɝ n ɪ tʃ ɚ
gesture: dʒ ɛ s tʃ ɚ
lecture: l ɛ k tʃ ɚ
mixture: m ɪ k s tʃ ɚ
moisture: m ɔɪ s tʃ ɚ
pasture: p æ s tʃ ɚ
structure: s t ɹ ʌ k tʃ ɚ
curious: k j ʊ ɹ i ə s
dangerous: d eɪ n dʒ ɚ ə s
enormous: ɪ n ɔ ɹ m ə s
jealous: dʒ ɛ l ə s
nervous: n ɝ v ə s
previous: p ɹ i v i ə s
serious: s ɪ ɹ i ə s
various: v ɛ ɹ i ə s
average: æ v ɹ ɪ dʒ
cabbage: k æ b ɪ dʒ
courage: k ɝ ɪ dʒ
garbage: ɡ ɑ ɹ b ɪ dʒ
language: l æ ŋ ɡ w ɪ dʒ
luggage: l ʌ ɡ ɪ dʒ
message: m ɛ s ɪ dʒ
package: p æ k ɪ dʒ
passage: p æ s ɪ dʒ
village: v ɪ l ɪ dʒ
ability: ə b ɪ l ə t i
activity: æ k t ɪ v ə t i
community: k ə m j u n ə t i
quality: k w ɑ l ə t i
quantity: k w ɑ n t ə t i
reality: ɹ i æ l ə t i
security: s ɪ k j ʊ ɹ ə t i
capital: k æ p ə t ə l
central: s ɛ n t ɹ ə l
hospital: h ɑ s p ɪ t ə l
local: l oʊ k ə l
metal: m ɛ t ə l
normal: n ɔ ɹ m ə l
personal: p ɝ s ə n ə l
royal: ɹ ɔɪ ə l
signal: s ɪ ɡ n ə l
special: s p ɛ ʃ ə l
basic: b eɪ s ɪ k
magic: m æ dʒ ɪ k
panic: p æ n ɪ k
plastic: p l æ s t ɪ k
public: p ʌ b l ɪ k
topic: t ɑ p ɪ k
traffic: t ɹ æ f ɪ k
comfortable: k ʌ m f ɚ t ə b ə l
possible: p ɑ s ə b ə l
terrible: t ɛ ɹ ə b ə l
visible: v ɪ z ə b ə l
"""

# targeted families the first gold eval showed the model had never
# seen: ph = f, soft c before i/y, u = ju, oo/ew/ue = u, -ear = ɪɹ,
# -ouse = aʊs, monosyllabic -ed/-es/-ing lookalikes, open-syllable long
# vowels vs doubled-consonant short vowels, and more -le words
_BASE_TEXT += """
photo: f oʊ t oʊ
phrase: f ɹ eɪ z
physical: f ɪ z ɪ k ə l
alphabet: æ l f ə b ɛ t
elephant: ɛ l ə f ə n t
telephone: t ɛ l ə f oʊ n
graph: ɡ ɹ æ f
paragraph: p ɛ ɹ ə ɡ ɹ æ f
nephew: n ɛ f j u
orphan: ɔ ɹ f ə n
trophy: t ɹ oʊ f i
dolphin: d ɑ l f ɪ n
cinema: s ɪ n ə m ə
circus: s ɝ k ə s
citizen: s ɪ t ə z ə n
civil: s ɪ v ə l
cycle: s aɪ k ə l
fancy: f æ n s i
icy: aɪ s i
juicy: dʒ u s i
mercy: m ɝ s i
princess: p ɹ ɪ n s ɛ s
recipe: ɹ ɛ s ə p i
spicy: s p aɪ s i
bicycle: b aɪ s ɪ k ə l
medicine: m ɛ d ə s ə n
exercise: ɛ k s ɚ s aɪ z
excite: ɪ k s aɪ t
precise: p ɹ ɪ s aɪ s
cute: k j u t
mute: m j u t
cube: k j u b
fume: f j u m
amuse: ə m j u z
excuse: ɪ k s k j u z
refuse: ɹ ɪ f j u z
confuse: k ə n f j u z
menu: m ɛ n j u
museum: m j u z i ə m
uniform: j u n ə f ɔ ɹ m
union: j u n j ə n
universe: j u n ə v ɝ s
pupil: p j u p ə l
fuel: f j u ə l
view: v j u
broom: b ɹ u m
gloom: ɡ l u m
scoop: s k u p
loop: l u p
troop: t ɹ u p
stool: s t u l
mood: m u d
blew: b l u
chew: tʃ u
crew: k ɹ u
dew: d u
drew: d ɹ u
flew: f l u
grew: ɡ ɹ u
knew: n u
screw: s k ɹ u
stew: s t u
threw: θ ɹ u
clue: k l u
due: d u
glue: ɡ l u
sue: s u
beard: b ɪ ɹ d
cheer: tʃ ɪ ɹ
steer: s t ɪ ɹ
peer: p ɪ ɹ
gear: ɡ ɪ ɹ
rear: ɹ ɪ ɹ
spear: s p ɪ ɹ
smear: s m ɪ ɹ
blouse: b l aʊ s
spouse: s p aʊ s
cone: k oʊ n
throne: θ ɹ oʊ n
clone: k l oʊ n
shone: ʃ oʊ n
cable: k eɪ b ə l
stable: s t eɪ b ə l
fable: f eɪ b ə l
able: eɪ b ə l
enable: ɪ n eɪ b ə l
label: l eɪ b ə l
maple: m eɪ p ə l
staple: s t eɪ p ə l
ladle: l eɪ d ə l
cradle: k ɹ eɪ d ə l
bacon: b eɪ k ə n
basin: b eɪ s ə n
apron: eɪ p ɹ ə n
tiger: t aɪ ɡ ɚ
spider: s p aɪ d ɚ
pilot: p aɪ l ə t
frozen: f ɹ oʊ z ə n
motor: m oʊ t ɚ
soda: s oʊ d ə
sofa: s oʊ f ə
zebra: z i b ɹ ə
meter: m i t ɚ
fever: f i v ɚ
legal: l i ɡ ə l
pepper: p ɛ p ɚ
copper: k ɑ p ɚ
ladder: l æ d ɚ
hammer: h æ m ɚ
manner: m æ n ɚ
banner: b æ n ɚ
rabbit: ɹ æ b ɪ t
happen: h æ p ə n
bitter: b ɪ t ɚ
litter: l ɪ t ɚ
tunnel: t ʌ n ə l
funnel: f ʌ n ə l
battle: b æ t ə l
cattle: k æ t ə l
puddle: p ʌ d ə l
saddle: s æ d ə l
paddle: p æ d ə l
rattle: ɹ æ t ə l
giggle: ɡ ɪ ɡ ə l
wiggle: w ɪ ɡ ə l
juggle: dʒ ʌ ɡ ə l
bubble: b ʌ b ə l
pebble: p ɛ b ə l
riddle: ɹ ɪ d ə l
kettle: k ɛ t ə l
puzzle: p ʌ z ə l
candle: k æ n d ə l
handle: h æ n d ə l
jungle: dʒ ʌ ŋ ɡ ə l
single: s ɪ ŋ ɡ ə l
ankle: æ ŋ k ə l
purple: p ɝ p ə l
turtle: t ɝ t ə l
sample: s æ m p ə l
temple: t ɛ m p ə l
marble: m ɑ ɹ b ə l
sparkle: s p ɑ ɹ k ə l
twinkle: t w ɪ ŋ k ə l
sled: s l ɛ d
fled: f l ɛ d
bled: b l ɛ d
shred: ʃ ɹ ɛ d
sped: s p ɛ d
chess: tʃ ɛ s
mess: m ɛ s
bless: b l ɛ s
stress: s t ɹ ɛ s
confess: k ə n f ɛ s
unless: ə n l ɛ s
sting: s t ɪ ŋ
cling: k l ɪ ŋ
fling: f l ɪ ŋ
strong: s t ɹ ɔ ŋ
yam: j æ m
yawn: j ɔ n
yogurt: j oʊ ɡ ɚ t
jet: dʒ ɛ t
lemon: l ɛ m ə n
melon: m ɛ l ə n
seven: s ɛ v ə n
eleven: ɪ l ɛ v ə n
velvet: v ɛ l v ə t
shadow: ʃ æ d oʊ
meadow: m ɛ d oʊ
elbow: ɛ l b oʊ
arrow: ɛ ɹ oʊ
pillow: p ɪ l oʊ
fellow: f ɛ l oʊ
swallow: s w ɑ l oʊ
borrow: b ɑ ɹ oʊ
sorrow: s ɑ ɹ oʊ
tomorrow: t ə m ɑ ɹ oʊ
widow: w ɪ d oʊ
minnow: m ɪ n oʊ
burrow: b ɝ oʊ
sparrow: s p ɛ ɹ oʊ
badge: b æ dʒ
dodge: d ɑ dʒ
fudge: f ʌ dʒ
hedge: h ɛ dʒ
ledge: l ɛ dʒ
lodge: l ɑ dʒ
nudge: n ʌ dʒ
pledge: p l ɛ dʒ
ridge: ɹ ɪ dʒ
smudge: s m ʌ dʒ
wedge: w ɛ dʒ
juice: dʒ u s
cruise: k ɹ u z
bruise: b ɹ u z
recruit: ɹ ɪ k ɹ u t
pity: p ɪ t i
silly: s ɪ l i
chilly: tʃ ɪ l i
jelly: dʒ ɛ l i
berry: b ɛ ɹ i
cherry: tʃ ɛ ɹ i
merry: m ɛ ɹ i
ferry: f ɛ ɹ i
marry: m ɛ ɹ i
sunny: s ʌ n i
bunny: b ʌ n i
puppy: p ʌ p i
kitty: k ɪ t i
body: b ɑ d i
forty: f ɔ ɹ t i
sixty: s ɪ k s t i
twenty: t w ɛ n t i
navy: n eɪ v i
crazy: k ɹ eɪ z i
tidy: t aɪ d i
shiny: ʃ aɪ n i
pony: p oʊ n i
holy: h oʊ l i
teen: t i n
screen: s k ɹ i n
thirteen: θ ɝ t i n
fourteen: f ɔ ɹ t i n
fifteen: f ɪ f t i n
sixteen: s ɪ k s t i n
canteen: k æ n t i n
yank: j æ ŋ k
yelp: j ɛ l p
yield: j i l d
"""


def _parse(text: str) -> Dict[str, Tuple[str, ...]]:
    out: Dict[str, Tuple[str, ...]] = {}
    for line in text.strip().split("\n"):
        word, _, phones = line.partition(":")
        out[word.strip()] = tuple(phones.split())
    return out


_VOICELESS = {"p", "t", "k", "f", "θ"}
_SIBILANT = {"s", "z", "ʃ", "ʒ", "tʃ", "dʒ"}
_SHORT_V = {"æ", "ɛ", "ɪ", "ɑ", "ʌ", "ɔ", "ʊ"}


def _plural(word: str, ipa: Tuple[str, ...]) -> Tuple[str, Tuple[str, ...]]:
    last = ipa[-1]
    if last in _SIBILANT:
        sp = word + ("es" if not word.endswith("e") else "s")
        return sp, ipa + ("ɪ", "z")
    if word.endswith("y") and len(word) > 1 and word[-2] not in "aeiou":
        return word[:-1] + "ies", ipa + ("z",)
    return word + "s", ipa + ("z" if last not in _VOICELESS else "s",)


def _doubles(word: str) -> bool:
    """CVC orthographic doubling before a vowel-initial suffix — only
    when the final syllable is stressed, which for this word list means
    monosyllables (stop→stopping) but NOT offer/visit/enter/listen."""
    import re

    if len(re.findall(r"[aeiouy]+", word)) != 1:
        return False
    return (len(word) >= 3 and word[-1] in "bdgmnprt"
            and word[-2] in "aeiou" and word[-3] not in "aeiou")


def _ing(word: str, ipa: Tuple[str, ...]) -> Tuple[str, Tuple[str, ...]]:
    if word.endswith("ie"):  # die→dying, tie→tying
        sp = word[:-2] + "ying"
    elif word.endswith("e") and not word.endswith("ee"):
        sp = word[:-1] + "ing"
    elif _doubles(word):
        sp = word + word[-1] + "ing"
    else:
        sp = word + "ing"
    return sp, ipa + ("ɪ", "ŋ")


def _past(word: str, ipa: Tuple[str, ...]) -> Tuple[str, Tuple[str, ...]]:
    last = ipa[-1]
    if word.endswith("e"):
        sp = word + "d"
    elif word.endswith("y") and len(word) > 1 and word[-2] not in "aeiou":
        sp = word[:-1] + "ied"
    elif _doubles(word):
        sp = word + word[-1] + "ed"
    else:
        sp = word + "ed"
    if last in ("t", "d"):
        return sp, ipa + ("ɪ", "d")
    return sp, ipa + ("t" if last in _VOICELESS or last in ("s", "ʃ", "tʃ", "k", "f", "p", "θ") else "d",)


# regular verbs from the base list that take -s / -ing / -ed with the
# orthography handled by the helpers above (strong verbs excluded —
# beat/bend/sell/shake/spin/wake stay base-form only: their pasts are
# irregular and '-ed' forms would be nonwords)
_REGULAR_VERBS = [
    "act", "add", "answer", "appear", "arrive", "ask", "attack", "avoid",
    "bake", "believe", "belong", "blame", "block", "boil",
    "borrow", "brush", "burn", "call", "camp", "carry", "cause", "chase",
    "check", "claim", "clean", "climb", "collect", "connect", "control",
    "cook", "copy", "count", "cover", "crack", "crash", "cross", "dance",
    "decide", "depend", "die", "dive", "drag", "dream", "dress", "drop",
    "dust", "end", "enjoy", "enter", "escape", "expect", "explain", "fail",
    "fear", "fill", "finish", "fix", "float", "flow", "fold", "follow",
    "form", "gain", "glow", "grab", "guess", "hate", "heat", "help",
    "hunt", "hurry", "join", "joke", "jump", "kick", "kill", "kiss",
    "knock", "lack", "land", "lean", "lift", "like", "limit", "listen",
    "live", "load", "lock", "look", "love", "mail", "mark", "match",
    "melt", "mention", "miss", "mix", "move", "nail", "need", "nod",
    "notice", "offer", "open", "order", "owe", "pack", "paint", "pass",
    "pick", "pitch", "plan", "please", "point", "pour", "practice",
    "press", "print", "promise", "prove", "pull", "push", "race", "rain",
    "raise", "reach", "remain", "remember", "remove", "rent", "repeat",
    "reply", "report", "rest", "return", "roar", "roll", "rub", "rush",
    "sail", "save", "scare", "score", "seem", "serve", "settle",
    "share", "shine", "shock", "shout", "sign", "smell", "smile",
    "smoke", "spell", "stamp", "stare", "start", "stay", "step",
    "stop", "study", "suppose", "support", "talk", "taste", "thank",
    "tie", "tip", "trade", "trap", "travel", "treat", "trick", "trust",
    "try", "turn", "type", "visit", "vote", "wait", "walk",
    "want", "wash", "watch", "wave", "wish", "worry", "wrap", "yell",
]

# nouns that pluralize regularly
_REGULAR_NOUNS = [
    "age", "animal", "answer", "area", "arm", "army", "aunt", "baby",
    "bag", "ball", "band", "bank", "basket", "bath", "beach", "bean",
    "bear", "bell", "belt", "bike", "bill", "bird", "bite", "block",
    "board", "bone", "book", "boss", "bottle", "bowl", "box", "boy",
    "brain", "branch", "brick", "bridge", "brush", "bus", "bush",
    "button", "cab", "cage", "cake", "camp", "cap", "car", "card",
    "case", "cell", "cent", "chain", "chair", "chance", "chest",
    "chicken", "chief", "chin", "choice", "church", "circle", "city",
    "class", "clock", "cloud", "club", "coach", "coat", "code", "coin",
    "college", "color", "corner", "cost", "course", "court", "cow",
    "crime", "crop", "crowd", "crown", "cup", "date", "day", "deal",
    "degree", "desk", "dish", "doctor", "dog", "doll", "door", "dress",
    "drink", "drum", "duck", "duty", "ear", "edge", "egg", "event",
    "eye", "face", "fact", "family", "fan", "farm", "fault", "fence",
    "field", "file", "film", "finger", "flag", "flame", "flower",
    "fool", "forest", "fork", "form", "fort", "fox", "frame", "friend",
    "frog", "game", "garden", "gate", "gift", "girl", "glass", "glove",
    "goat", "grade", "group", "guard", "guest", "guide", "gun", "hand",
    "hat", "hen", "hill", "hint", "hole", "hook", "horn", "horse",
    "hotel", "hour", "house", "idea", "inch", "island", "jacket",
    "jar", "jaw", "job", "key", "kid", "kite", "lady", "lake", "lamp",
    "lane", "leg", "lesson", "letter", "level", "lie", "light", "limit",
    "line", "lion", "lip", "list", "loan", "log", "lord", "machine",
    "man", "map", "market", "meal", "member", "mile", "mine", "minute",
    "mistake", "model", "moment", "mountain", "mouth", "mug", "nail",
    "name", "neck", "needle", "neighbor", "nest", "net", "night",
    "noise", "nose", "note", "number", "nurse", "nut", "ocean",
    "office", "owl", "page", "pail", "pair", "pan", "parent", "park",
    "part", "party", "path", "pen", "pencil", "penny", "person", "pet",
    "picture", "pie", "piece", "pig", "pile", "pin", "pipe", "place",
    "plane", "plant", "plate", "pocket", "point", "pole", "pond",
    "pool", "port", "pot", "price", "prize", "problem", "queen",
    "question", "rail", "ranch", "range", "rat", "rate", "reason",
    "record", "river", "road", "rock", "roof", "room", "root", "rope",
    "rose", "rule", "sail", "sea", "season", "seat", "secret", "seed",
    "shade", "shape", "sheet", "shell", "ship", "shirt", "shoe",
    "shop", "shore", "side", "sign", "sister", "size", "skill", "skirt",
    "snake", "sock", "song", "sort", "sound", "soup", "space", "spoon",
    "sport", "spot", "stage", "stair", "stamp", "star", "state", "stem",
    "step", "stick", "stone", "store", "storm", "story", "stove",
    "stream", "street", "string", "subject", "suit", "system", "tail",
    "tale", "tank", "tape", "task", "tax", "team", "tent", "term",
    "test", "thing", "time", "tip", "toe", "tool", "tooth", "top",
    "town", "toy", "trail", "train", "tree", "trick", "trip", "truck",
    "tube", "tune", "twin", "unit", "valley", "value", "village",
    "voice", "wage", "wall", "wave", "way", "week", "wheel", "wife",
    "window", "wing", "wire", "word", "yard", "year", "zone",
]

# adjectives that take adverbial -ly (pron + l i; final -le → -ly)
_LY_ADJECTIVES = [
    "bad", "bold", "brave", "bright", "broad", "calm", "cheap", "clear",
    "close", "cold", "correct", "dark", "dead", "deep", "direct",
    "exact", "fair", "final", "fresh", "glad", "great", "high", "kind",
    "large", "late", "light", "loud", "low", "mad", "main", "nice",
    "normal", "perfect", "personal", "plain", "poor", "proud", "quick",
    "quiet", "rich", "rough", "rude", "sad", "safe", "serious", "sharp",
    "short", "shy", "sick", "silent", "slow", "smooth", "soft",
    "special", "strange", "strong", "sudden", "sweet", "tight", "weak",
    "wide", "wild", "wise", "wrong",
]

# gold-set words (tests/test_g2p_coverage.py) — NEVER in training data,
# the gate measures generalization
_GOLD_WORDS = {
    "make", "making", "time", "times", "hope", "cake", "name", "home",
    "side", "bright", "teacher", "station", "nation", "nature", "famous",
    "played", "table", "little", "apple", "find", "cold", "car", "care",
    "bird", "turn", "corner", "store", "near", "rain", "boat", "moon",
    "mouse", "snow", "coin", "blue", "fruit", "judge", "bridge", "city",
    "page", "phone", "green", "street", "spring", "think", "catch",
    "lunch", "stand", "plant", "walking", "started", "stopped",
    "running", "happy", "yellow", "window", "paper", "open", "music",
    "riding", "red", "bed", "fed", "led", "wed", "shed", "yes", "ring",
    "sing", "king",
}


def expanded_lexicon() -> Dict[str, Tuple[str, ...]]:
    """Base entries + core g2p lexicon + regular inflections, minus the
    gold set."""
    from phones_las_torch.data.g2p import _EN_LEXICON

    lex = _parse(_BASE_TEXT)
    for w, p in _EN_LEXICON.items():
        lex.setdefault(w, tuple(p))
    base = dict(lex)
    for w in _REGULAR_VERBS:
        ipa = base.get(w)
        if ipa is None:
            continue
        for form in (_plural(w, ipa), _ing(w, ipa), _past(w, ipa)):
            lex.setdefault(form[0], form[1])
    for w in _REGULAR_NOUNS:
        ipa = base.get(w)
        if ipa is not None:
            sp, pron = _plural(w, ipa)
            lex.setdefault(sp, pron)
    for w in _LY_ADJECTIVES:
        ipa = base.get(w)
        if ipa is None:
            continue
        if w.endswith("le") and len(ipa) >= 2 and ipa[-2:] == ("ə", "l"):
            lex.setdefault(w[:-1] + "y", ipa[:-2] + ("l", "i"))
        else:
            lex.setdefault(w + "ly", ipa + ("l", "i"))
    for g in _GOLD_WORDS:
        lex.pop(g, None)
    return lex


def lexicon_phone_inventory() -> List[str]:
    phones = set()
    for pron in expanded_lexicon().values():
        phones.update(pron)
    return sorted(phones)
